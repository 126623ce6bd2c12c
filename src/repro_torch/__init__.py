"""FedHeN on PyTorch and CUDA: the port of ``repro`` (JAX on a TPU).

The package mirrors ``repro``'s module names so each counterpart is easy
to find, but it imports nothing of ``repro`` (nor JAX): where it needs a
framework-free module of the reference it keeps its own copy.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"`` (see
:mod:`repro_torch.device`); on the CPU every kernel wrapper runs its plain
PyTorch version.
"""
