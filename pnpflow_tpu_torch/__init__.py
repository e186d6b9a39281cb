"""PyTorch / CUDA port of ``pnpflow_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference this port is held against.  The
module paths and names follow ``pnpflow_tpu`` so each piece's counterpart is
easy to find; the port imports nothing of it (nor of JAX).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--opts device cpu`` on the CLI); see :mod:`pnpflow_tpu_torch.device`.
"""
