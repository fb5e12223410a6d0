"""golf_tpu_torch: the PyTorch/CUDA port of golf_tpu for one NVIDIA H100.

The package mirrors ``golf_tpu``'s layout (``core/``, ``ops/``, ``models/``,
``tasks/``, ``config/``) so each module's counterpart is easy to find. It
imports ``torch`` and never JAX or ``golf_tpu``. Every Pallas kernel on the
ported path has a hand-written CUDA kernel in ``kernels/csrc/``; its
wrapper launches it for CUDA tensors and uses the plain PyTorch version
beside it only for CPU tensors.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
