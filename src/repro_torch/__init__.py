"""repro_torch — PyTorch/CUDA port of the FAME HE matrix multiplication.

The JAX package ``repro`` is the reference; this package reproduces its
single-device main path (Algorithm 2 on the fused ``"pallas"`` schedule)
with plain PyTorch around four hand-written CUDA kernels
(``repro_torch/csrc``).  Residues are stored as ``torch.int32`` (every
prime is < 2^30) and plain tensor code computes in ``int64``; the kernels
read the same bits as ``uint32``.

Entry points (``CkksEngine``, ``HEContext``) run on ``cuda`` unless the
caller passes ``device="cpu"``; without a GPU they raise instead of
falling back.  This package never imports ``jax`` or ``repro``.
"""

__version__ = "0.1.0"
