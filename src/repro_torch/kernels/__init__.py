# Hand-written Hopper kernels, one package each: <name>.py (loader and
# wrapper), csrc/ (CUDA sources), ref.py (plain PyTorch version), ops.py
# (the entry points that pick kernel or plain version by device).
import torch

NO_BACKWARD = (
    "{kernel} has no backward: neither this package nor the JAX package "
    "has a backward kernel for it, so a gradient cannot flow through it. "
    "Train with attn_impl=\"naive\" or \"blockwise\" and ssm_impl=\"jnp\" "
    "(the configs' defaults); the kernels serve and score under "
    "torch.no_grad().")


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record a call of the forward-only
    ``kernel``: grad mode on and an input that requires grad, on either
    device (the CUDA launch is invisible to autograd, and the CPU's plain
    version stands in for that kernel, as the JAX package's interpret-mode
    kernel cannot be differentiated either)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(NO_BACKWARD.format(kernel=kernel))


def refuse_fake(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise where ``kernel`` is handed fake tensors (``FakeTensorMode``,
    the dry-run's): a kernel needs data to launch on, and its plain
    version would trace what the card does not run."""
    from torch._subclasses.fake_tensor import FakeTensor
    if any(isinstance(t, FakeTensor) for t in tensors):
        raise RuntimeError(
            f"{kernel} cannot run on fake tensors: the dry-run traces the "
            f"per-rank program without a card, and a kernel has no trace. "
            f"Dry-run with attn_impl=\"naive\" or \"blockwise\" and "
            f"ssm_impl=\"jnp\" (the configs' defaults).")
