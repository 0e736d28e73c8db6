"""FCVI in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The port of ``repro`` (JAX/Pallas), one slice at a time. It imports torch
and numpy, never JAX or the ``repro`` package. Layout mirrors ``repro``:

  * ``core``    - transform (psi), theory (k'), the FCVI index and query;
  * ``index``   - the flat backend;
  * ``kernels`` - the CUDA kernels, their plain PyTorch versions, and the
    ``ops`` layer that picks between them by the device of the inputs;
  * ``serve``   - the meshless serving engine;
  * ``data``    - synthetic corpora.

Numerics: TF32 is switched off for matmuls and cuDNN at import. TF32 keeps
about three decimal digits, and the plain versions' L2 expansion
``||q||^2 - 2 q.x + ||x||^2`` would then drift by more than the exact refine
over ``REFINE_PAD`` extra candidates can absorb.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
