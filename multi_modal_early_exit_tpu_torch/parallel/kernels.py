"""The head-form attention kernels under a device mesh.

The counterpart of the JAX package's ``parallel/kernels.py``: there
``shard_map`` runs one local ``flash_attention`` per device, with batch on
the data axis and heads on the model axis. The attention is independent per
(batch, head), so no communication is needed. Here each rank is one process:
``sharded_flash_attention`` takes the full (B, H, S, D) inputs, which every
rank holds, and runs the port's head-form ``flash_attention`` (on CUDA
tensors the forward #5 and, under autograd, the backward #6) on this rank's
(B/dp, H/tp) block. It returns that block.

With ``dropout_rate > 0`` each shard's kernel hashes its LOCAL (batch, head)
indices, so its seed is offset by the shard's linear index, as in the JAX
package: ``seed + (data_index * model + model_index) * 1000003`` in int32
arithmetic. The masks are then statistically the same as the unsharded
kernel's, not bit-equal to them. At rate 0 the block is the unsharded
kernel's block bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from multi_modal_early_exit_tpu_torch.parallel.layers import shard_seed
from multi_modal_early_exit_tpu_torch.parallel.mesh import Mesh


def shard_block(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's (B/dp, H/tp, ...) block of a (B, H, ...) tensor (a view)."""
    b, h = x.shape[0] // mesh.data_size, x.shape[1] // mesh.model_size
    return x[mesh.data_index * b:(mesh.data_index + 1) * b,
             mesh.model_index * h:(mesh.model_index + 1) * h]


def sharded_flash_attention(
    mesh: Mesh,
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (B, H, S', S')
    block_q: Optional[int] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
) -> torch.Tensor:
    """``flash_attention`` with batch split on the data axis and heads on the
    model axis: this rank's (B/dp, H/tp, S, D) block of the output,
    differentiable in the inputs' blocks. Requires B % data == 0 and
    H % model == 0 (``ValueError`` otherwise)."""
    from multi_modal_early_exit_tpu_torch.ops.flash_attention import flash_attention

    data, model = mesh.data_size, mesh.model_size
    if q.shape[0] % data or q.shape[1] % model:
        raise ValueError(
            f"batch {q.shape[0]} / heads {q.shape[1]} not divisible by "
            f"mesh (data={data}, model={model})"
        )
    seed = None
    if dropout_rate > 0.0:
        base = 0 if dropout_seed is None else int(torch.as_tensor(dropout_seed).reshape(-1)[0])
        seed = shard_seed(base, mesh.shard_index)
    q, k, v, bias = (shard_block(x, mesh) for x in (q, k, v, bias))
    if q.device.type == "cuda":  # the kernels' tensor maps need a unit last stride
        q, k, v, bias = (x.contiguous() for x in (q, k, v, bias))
    return flash_attention(q, k, v, bias, block_q or 128, dropout_rate=dropout_rate,
                           dropout_seed=seed)
