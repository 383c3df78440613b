from tron_jax.kernels.kb import besseli0, kb_beta, kb_kernel, kb_hat

__all__ = ["besseli0", "kb_beta", "kb_kernel", "kb_hat"]
