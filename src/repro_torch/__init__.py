"""FLeNS on PyTorch and CUDA: the port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro``'s module names (``core``, ``kernels``,
``comm``, ``data``) so each counterpart is easy to find, and holds its
own copies of everything it needs: it imports ``torch``, numpy and the
standard library, never JAX or ``repro``.

Entry points that create tensors take ``device=`` (default ``"cuda"``)
and raise when CUDA is absent; CPU runs ask for ``device="cpu"``.
"""
