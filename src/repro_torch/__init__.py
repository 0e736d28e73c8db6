"""FCVI in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The port of ``repro`` (JAX/Pallas), one slice at a time. It imports torch
and numpy, never JAX or the ``repro`` package. Layout mirrors ``repro``:

  * ``core``    - transform (psi), theory (k'), k-means, the FCVI index and
    query;
  * ``index``   - the flat, IVF and PQ backends, the serving slabs and
    their shard layouts, and the cross-shard merges;
  * ``kernels`` - the CUDA kernels, their plain PyTorch versions, and the
    ``ops`` layer that picks between them by the device of the inputs;
  * ``serve``   - the serving engine, meshless or sharded over a mesh
    (routed and degraded serving, shard health, fault injection);
  * ``models``  - the LMs of every registered arch (dense, MoE,
    recurrent, the encoder-decoder; forward, prefill and decode) that
    embed documents for FCVI;
  * ``configs`` - their architecture configs (shapes only);
  * ``launch``  - device meshes (``ShardMesh``) and the serving launcher;
  * ``distributed`` - sharding rules and the fault-tolerance policies;
  * ``checkpoint`` - checkpoints in the reference's format;
  * ``data``    - synthetic corpora.

Numerics: TF32 is switched off for matmuls and cuDNN at import. TF32 keeps
about three decimal digits, and the plain versions' L2 expansion
``||q||^2 - 2 q.x + ||x||^2`` would then drift by more than the exact refine
over ``REFINE_PAD`` extra candidates can absorb. bf16 matmuls keep fp32
accumulation (cuBLAS may otherwise round split-K partial sums to bf16), as
the reference's bf16 dots accumulate in fp32.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
