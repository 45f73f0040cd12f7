"""Trainers of the port: the single-device FFN trainer (slice 2), the
single-device LM trainer (slice 3), DDP and FSDP of the FFN stack over n
ranks (slice 4), expert parallelism of the MoE FFN stack (slice 5), and
tensor parallelism (plain and sequence-parallel) and the DDP x TP hybrid
of the FFN stack, ZeRO-1, and the single-device trainer, DDP, FSDP,
Megatron TP and the DDP x TP hybrid of the transformer and of the LM,
with the vocab-parallel embedding, cross-entropy and fused head, and
sequence parallelism (ring attention and Ulysses) of the transformer and
of the LM, with the mesh, the collectives and the launcher they run
on."""

from .collectives import (all_gather, all_reduce, all_to_all, axis_index,
                          pmax, ppermute, reduce_scatter)
from .ddp import train_ddp
from .expert import moe_layer_ep, train_moe_dense, train_moe_ep
from .fsdp import shard_params, train_fsdp, unshard_params
from .hybrid import train_hybrid
from .launcher import (launch, launch_replicated, launch_strided,
                       run_replicated, run_strided)
from .lm import (lm_grads, resolve_head, train_lm_ddp, train_lm_fsdp,
                 train_lm_hybrid, train_lm_seq, train_lm_single, train_lm_tp,
                 vp_embed, vp_head_xent, vp_xent)
from .mesh import (DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh,
                   make_mesh, require_axes)
from .sequence import (resolve_seq_attn, ring_attention,
                       sequence_parallel_attention, ulysses_attention,
                       ulysses_parallel_attention)
from .single import make_step, train_single
from .tp import train_tp, train_tp_sp
from .tp import unshard_params as unshard_tp_params
from .transformer import (resolve_attn, train_transformer_ddp,
                          train_transformer_fsdp, train_transformer_hybrid,
                          train_transformer_seq, train_transformer_single,
                          train_transformer_tp)
from .zero1 import train_ddp_zero1

__all__ = ["DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "Mesh", "SEQ_AXIS",
           "all_gather", "all_reduce", "all_to_all", "axis_index", "launch",
           "launch_replicated", "launch_strided", "lm_grads", "make_mesh",
           "make_step", "moe_layer_ep", "pmax", "ppermute", "reduce_scatter",
           "require_axes", "resolve_attn", "resolve_head",
           "resolve_seq_attn", "ring_attention", "run_replicated",
           "run_strided", "sequence_parallel_attention", "shard_params",
           "train_ddp", "train_ddp_zero1", "train_fsdp", "train_hybrid",
           "train_lm_ddp", "train_lm_fsdp", "train_lm_hybrid",
           "train_lm_seq", "train_lm_single", "train_lm_tp",
           "train_moe_dense", "train_moe_ep", "train_single", "train_tp",
           "train_tp_sp", "train_transformer_ddp", "train_transformer_fsdp",
           "train_transformer_hybrid", "train_transformer_seq",
           "train_transformer_single", "train_transformer_tp",
           "ulysses_attention", "ulysses_parallel_attention",
           "unshard_params", "unshard_tp_params", "vp_embed", "vp_head_xent",
           "vp_xent"]
