"""Mixtral-class sparse MoE decoder, training half: the counterpart of
``skypilot_tpu/models/mixtral.py`` (config, init, top-2 capacity routing,
the MoE MLP, the layer and ``forward`` with the router's aux loss).

Attention is the port's llama ``attention_block`` (the flash kernels on
the card); only the MLP differs. Routing is GShard-style top-2 with a
capacity per expert, computed as one-hot dispatch and combine tensors and
applied as matmuls, as in the JAX package; its arithmetic is kept
exactly: first-max argmax, positions from a cumsum in the gates' f32,
``capacity = max(int(cf * top_k * t / e), top_k)``, the Switch aux loss
``sum(density * density_proxy) * e^2``. Weights keep the JAX layout:
router (dim, E) in f32, experts (E, dim, mlp) and (E, mlp, dim).

On a mesh (``forward`` under ``mesh_lib.use_mesh``, as the sharded train
step calls it) each layer runs through llama's ``LayerView`` and
``_moe_mlp_sharded``: expert parallelism over ``ep``, with the routing
of the whole batch (what XLA's partition of the JAX MoE computes), its
rows split over the data axes and each row's sequence over ``sp``.

Serving (below the training half): ``quantize_params`` (llama's int8
scheme over the attention and expert weights, the router left f32), and
the KV-cache paths (``forward_with_cache``, ``forward_with_paged_cache``,
``verify_step``, ``verify_step_paged``, ``decode``), each llama's with
the MLP swapped for ``_moe_block``: dense top-2 routing
(``_moe_mlp_dense``), where every expert runs on every token and the two
chosen ones are combined. Capacity routing makes a token's output depend
on the other tokens in the batch, so an incremental decode could never
reproduce a whole pass; dense routing is per token, and equals the
capacity path whenever no token is dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from skypilot_tpu_torch import DeviceLike, resolve_device
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.parallel import mesh as mesh_lib
from skypilot_tpu_torch.parallel import placement, seq_gather


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 14336
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.02
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "auto"  # auto|kernel|reference
    remat: bool = True            # full per-layer checkpoint

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def mixtral_8x7b() -> "MixtralConfig":
        return MixtralConfig()

    @staticmethod
    def tiny(vocab_size: int = 256) -> "MixtralConfig":
        return MixtralConfig(vocab_size=vocab_size, dim=64, n_layers=2,
                             n_heads=4, n_kv_heads=2, mlp_dim=128,
                             n_experts=4, top_k=2, max_seq_len=256)

    def flops_per_token(self) -> float:
        """6 x the parameters a token passes through (top_k experts)."""
        attn = self.dim * (self.n_heads + 2 * self.n_kv_heads) * \
            self.head_dim + self.n_heads * self.head_dim * self.dim
        moe = self.top_k * 3 * self.dim * self.mlp_dim
        router = self.dim * self.n_experts
        p_active = self.n_layers * (attn + moe + router) + \
            2 * self.vocab_size * self.dim
        return 6.0 * p_active

    def num_params(self) -> int:
        d, hd = self.dim, self.head_dim
        p_layer = (d * (self.n_heads + 2 * self.n_kv_heads) * hd +
                   self.n_heads * hd * d + 2 * d + d * self.n_experts +
                   3 * self.n_experts * d * self.mlp_dim)
        return self.n_layers * p_layer + d + 2 * self.vocab_size * d


def layer_shapes(cfg: MixtralConfig) -> dict:
    """(name, shape) of each layer weight, in the JAX tree's layout."""
    d, hd, e = cfg.dim, cfg.head_dim, cfg.n_experts
    return {
        "attn_norm": (d,),
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
        "mlp_norm": (d,),
        "router": (d, e),
        "w_gate": (e, d, cfg.mlp_dim),
        "w_up": (e, d, cfg.mlp_dim),
        "w_down": (e, cfg.mlp_dim, d),
    }


def param_specs(cfg: MixtralConfig, *, quantized: bool = False) -> dict:
    """Logical-axis names for every parameter: the JAX package's
    ``param_specs`` without the stacked ``layers`` axis (llama's rule).
    Expert tensors split their ``mlp`` axis over tp (Megatron per
    expert: w_gate and w_up by columns, w_down by rows); ``expert`` goes
    on ``ep``, which no serving mesh has; the f32 router is whole.
    ``quantized``: each int8 weight's ``<name>_scale`` keeps the weight's
    axes minus its in-features axis (JAX's ``spec[:-2] + spec[-1:]``)."""
    specs = {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("embed",),
            "wq": ("embed", "q_heads_x_dim"),
            "wk": ("embed", "kv_heads_x_dim"),
            "wv": ("embed", "kv_heads_x_dim"),
            "wo": ("q_heads_x_dim", "embed"),
            "mlp_norm": ("embed",),
            "router": ("embed", None),
            "w_gate": ("expert", "embed", "mlp"),
            "w_up": ("expert", "embed", "mlp"),
            "w_down": ("expert", "mlp", "embed"),
        },
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }
    if quantized:
        specs["embed_scale"] = ("vocab",)
        for name in llama.QUANT_LAYER_WEIGHTS:
            spec = specs["layers"][name]
            specs["layers"][name + "_scale"] = spec[:-2] + spec[-1:]
        specs["lm_head_scale"] = ("vocab",)
    return specs


# The router stays f32 whatever the config dtype (routing is a discrete
# argmax).
ROUTER_DTYPE = torch.float32


class MixtralLayer(nn.Module):
    """One decoder layer's weights; ``forward`` is the JAX ``_layer``."""

    def __init__(self, cfg: MixtralConfig, device, dtype):
        super().__init__()
        for name, shape in layer_shapes(cfg).items():
            dt = ROUTER_DTYPE if name == "router" else dtype
            setattr(self, name, nn.Parameter(
                torch.empty(shape, device=device, dtype=dt)))

    def forward(self, cfg: MixtralConfig, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return _layer(cfg, x, self, positions)


class MixtralParams(nn.Module):
    """embed, layers[i], final_norm, lm_head."""

    def __init__(self, cfg: MixtralConfig, device, dtype):
        super().__init__()

        def empty(shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype))
        self.embed = empty((cfg.vocab_size, cfg.dim))
        self.layers = nn.ModuleList(
            MixtralLayer(cfg, device, dtype) for _ in range(cfg.n_layers))
        self.final_norm = empty((cfg.dim,))
        self.lm_head = empty((cfg.dim, cfg.vocab_size))


@torch.no_grad()
def init(cfg: MixtralConfig, generator: torch.Generator,
         device: DeviceLike = None, *, quantize: bool = False,
         layer_hook=None) -> MixtralParams:
    """Random init as the JAX package draws it (normal * fan_in^-0.5,
    norms at one, the router in f32), from ``generator``; the numbers
    differ from JAX's PRNG. ``device`` defaults to the card.

    ``quantize=True`` returns ``quantize_params(cfg, init(cfg, generator,
    device))``, the same numbers, drawn and quantized a layer at a time,
    so that no more than one layer is held in the config dtype:
    Mixtral-8x7B is 93.4 GB in bf16, more than one 80 GB card holds, and
    46.7 GB in int8. ``layer_hook(i, layer)``, when given, takes each
    layer as soon as it is drawn (and quantized) and returns what the tree
    keeps in its place: a tensor-parallel rank keeps its shard
    (``serve/gang_replica.py`` ``shard_init``), never the whole tree."""
    device = resolve_device(device)
    staged = quantize or layer_hook is not None
    params = MixtralParams(cfg, "meta" if staged else device, cfg.dtype)
    if staged:
        for name in ("embed", "final_norm", "lm_head"):
            setattr(params, name, nn.Parameter(torch.empty_like(
                getattr(params, name), device=device)))

    def dense(p: torch.Tensor, fan_in: int) -> None:
        x = torch.randn(p.shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        # Rounded through the config dtype first, as JAX casts the f32
        # router from a dtype-rounded draw.
        p.copy_((x * fan_in ** -0.5).to(cfg.dtype))

    dense(params.embed, cfg.dim)
    if quantize:
        _quantize_into(params, params, "embed", -1)
    for i in range(cfg.n_layers):
        lp = MixtralLayer(cfg, device, cfg.dtype) if staged else \
            params.layers[i]
        lp.attn_norm.fill_(1.0)
        lp.mlp_norm.fill_(1.0)
        for name in ("wq", "wk", "wv", "router", "w_gate", "w_up"):
            dense(getattr(lp, name), cfg.dim)
        dense(lp.wo, cfg.n_heads * cfg.head_dim)
        dense(lp.w_down, cfg.mlp_dim)
        if staged:
            layer = _quantized_layer(cfg, lp) if quantize else lp
            del lp
            params.layers[i] = (layer_hook(i, layer) if layer_hook
                                else layer)
    params.final_norm.fill_(1.0)
    dense(params.lm_head, cfg.dim)
    if quantize:
        _quantize_into(params, params, "lm_head", -2)
    return params


def capacity(cfg: MixtralConfig, tokens: int) -> int:
    """Slots per expert: max(int(cf * top_k * t / e), top_k)."""
    return max(int(cfg.capacity_factor * cfg.top_k * tokens /
                   cfg.n_experts), cfg.top_k)


def _top2_dispatch(gates: torch.Tensor, capacity: int,
                   share: Optional["_BatchShare"] = None,
                   combine_gates: Optional[torch.Tensor] = None,
                   rows: int = 1
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GShard-style top-2 capacity routing.

    gates: (T, E) softmax probabilities.
    Returns (dispatch (T, E, C) bool, combine (T, E, C) f32, aux_loss ()).

    ``share``: the rest of the batch when these are one rank's tokens,
    ``rows`` batch rows of one sequence chunk (``_BatchShare``):
    positions continue the counts of the tokens before them in the whole
    batch, and the aux loss's means are the whole batch's.
    ``combine_gates``: the gates the combine weights are read from (the
    same values; on a mesh, their gradient is summed over the ranks that
    hold the other experts), ``gates`` by default.
    """
    t, e = gates.shape
    idx1 = torch.argmax(gates, dim=-1)          # first max, as jnp.argmax
    mask1 = F.one_hot(idx1, e).to(gates.dtype)
    gates_no1 = gates * (1.0 - mask1)
    idx2 = torch.argmax(gates_no1, dim=-1)
    mask2 = F.one_hot(idx2, e).to(gates.dtype)

    # Switch load-balancing loss: the share of tokens whose first choice
    # is each expert times the mean router probability per expert.
    if share is None:
        density = mask1.mean(dim=0)
        density_proxy = gates.mean(dim=0)
        before1 = before2 = 0.0
        total1 = mask1.sum(dim=0, keepdim=True)
    else:
        before1, before2, total1, density, density_proxy = share.stats(
            mask1, mask2, gates, rows)
    aux = (density * density_proxy).sum() * (e ** 2) / 1.0

    # Positions within each expert's buffer; tokens past capacity dropped.
    pos1 = (torch.cumsum(mask1, dim=0) + before1) * mask1 - mask1
    keep1 = (pos1 < capacity) * mask1
    pos2 = (torch.cumsum(mask2, dim=0) + before2 + total1) * mask2 - mask2
    keep2 = (pos2 < capacity) * mask2

    cg = gates if combine_gates is None else combine_gates
    g1 = (cg * keep1).sum(dim=-1)
    g2 = (cg * keep2).sum(dim=-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom

    cap_iota = torch.arange(capacity, dtype=pos1.dtype, device=gates.device)
    # (T, E, C) one-hots of each token's slot in each expert buffer.
    slot1 = keep1[:, :, None] * (pos1[:, :, None] == cap_iota)
    slot2 = keep2[:, :, None] * (pos2[:, :, None] == cap_iota)
    combine = g1[:, None, None] * slot1 + g2[:, None, None] * slot2
    dispatch = (slot1 + slot2) > 0
    return dispatch, combine.float(), aux


def router_gates(y: torch.Tensor, lp: nn.Module) -> torch.Tensor:
    """(B, S, D) -> (T, E) softmax of the f32 router logits."""
    return torch.softmax(y.reshape(-1, y.shape[-1]).float() @ lp.router,
                         dim=-1)


def _moe_mlp(cfg: MixtralConfig, y: torch.Tensor, lp: nn.Module
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y: (B, S, D) -> (B, S, D), aux loss. The dispatch and combine
    einsums of the JAX package, as matmuls over the flattened (E * C)
    slots; the experts as batched matmuls over E."""
    b, s, d = y.shape
    t, e = b * s, cfg.n_experts
    cap = capacity(cfg, t)
    yt = y.reshape(t, d)
    dispatch, combine, aux = _top2_dispatch(router_gates(y, lp), cap)
    # "tec,td->ecd"
    xs = (dispatch.reshape(t, e * cap).to(y.dtype).t() @ yt).reshape(
        e, cap, d)
    gate = F.silu(torch.bmm(xs, lp.w_gate))                  # "ecd,edm->ecm"
    up = torch.bmm(xs, lp.w_up)
    out = torch.bmm(gate * up, lp.w_down)                    # "ecm,emd->ecd"
    # "tec,ecd->td"
    yo = combine.reshape(t, e * cap).to(y.dtype) @ out.reshape(e * cap, d)
    return yo.reshape(b, s, d), aux


def _layer(cfg: MixtralConfig, x: torch.Tensor, lp: nn.Module,
           positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = llama.attention_block(cfg, x, lp, positions)
    y = llama.rms_norm(x, lp.mlp_norm, cfg.norm_eps)
    moe_out, aux = _moe_mlp(cfg, y, lp)
    return x + moe_out, aux


def forward(cfg: MixtralConfig, params: MixtralParams, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None):
    """Token ids (B, S) -> (fp32 logits (B, S, vocab), router aux loss
    scaled by router_aux_weight / n_layers): training without the aux loss
    collapses the router.

    Under an ambient mesh (``mesh_lib.use_mesh``, as the sharded train
    step enters it), the sharded forward: ``_forward_sharded``."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    ambient = mesh_lib.current_mesh_rules()
    if ambient is not None:
        return _forward_sharded(cfg, params, tokens, positions, ambient)
    x = llama.embed_tokens(params, tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.layers:
        if cfg.remat:
            x, aux = checkpoint(lp, cfg, x, positions, use_reentrant=False)
        else:
            x, aux = lp(cfg, x, positions)
        aux_total = aux_total + aux
    logits = llama.lm_head(cfg, params, x)
    return logits, cfg.router_aux_weight * aux_total / cfg.n_layers


# ------------------------------------------------------- the sharded forward

class _BatchShare:
    """One rank's place in the global batch: the batch is split by rows
    over the mesh's data axes (dp, fsdp; row-major, as the sharded step
    feeds it) and each row by sequence chunks over ``sp``, and JAX routes
    the whole batch at once, its tokens in (b, s) order. ``stats``
    gathers every such rank's per-row expert counts and gate sums (one
    all-gather over each axis, no gradient) and returns what
    ``_top2_dispatch`` needs to route this rank's tokens as the whole
    batch routes them: each local token's count of first and second
    choices before it in that order (the whole rows of the data ranks
    before, the rows before it, and in its own row the chunks before
    this one; a cumsum over the local tokens continues there), the global
    count of first choices (``pos2`` adds it), and the aux loss's global
    means. ``density_proxy`` holds the other ranks' gate sums as
    constants: its value is the global mean on every rank, its gradient
    this rank's share, so the gradients summed over the data and sp axes
    count the aux loss once."""

    def __init__(self, mesh):
        # Gathered sp first, then fsdp, then dp: batch-row order, each
        # row's chunks in sequence order.
        self.groups = [g for g in (mesh_lib.axis_group(mesh, mesh_lib.SP),
                                   mesh_lib.axis_group(mesh, mesh_lib.FSDP),
                                   mesh_lib.axis_group(mesh, mesh_lib.DP))
                       if g is not None]
        self.sp = mesh_lib.axis_size(mesh, mesh_lib.SP)
        self.chunk = mesh_lib.axis_index(mesh, mesh_lib.SP)
        self.n = (mesh_lib.axis_size(mesh, mesh_lib.DP) *
                  mesh_lib.axis_size(mesh, mesh_lib.FSDP) * self.sp)
        self.index = (mesh_lib.axis_index(mesh, mesh_lib.DP) *
                      mesh_lib.axis_size(mesh, mesh_lib.FSDP) +
                      mesh_lib.axis_index(mesh, mesh_lib.FSDP))

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """(n, *t.shape): ``t`` of every rank of the groups, in
        batch-row and sequence order."""
        parts = t.detach()[None].contiguous()
        for group in self.groups:
            out = [torch.empty_like(parts)
                   for _ in range(dist.get_world_size(group))]
            dist.all_gather(out, parts, group=group)
            parts = torch.cat(out)
        return parts

    def stats(self, mask1, mask2, gates, rows: int):
        """``rows``: the local batch rows, each of T / rows tokens."""
        t_local, e = gates.shape
        per_row = torch.stack([mask1, mask2, gates]).reshape(
            3, rows, t_local // rows, e).sum(dim=2)          # (3, rows, E)
        every = self.gather(per_row)                       # (n, 3, rows, E)
        j = self.index * self.sp + self.chunk
        mine = every[j - self.chunk:j - self.chunk + self.sp]
        row_totals = mine.sum(dim=0)
        own = every[j]
        before = (every[:j - self.chunk].sum(dim=(0, 2))[:, None] +
                  row_totals.cumsum(dim=1) - row_totals +
                  mine[:self.chunk].sum(dim=0) - (own.cumsum(dim=1) - own))
        before = before[:2, :, None].expand(2, rows, t_local // rows, e
                                            ).reshape(2, t_local, e)
        t = t_local * self.n
        others = torch.cat([every[:j], every[j + 1:]])[:, 2].sum(dim=(0, 1))
        total1 = every[:, 0].sum(dim=(0, 1))[None]
        density = total1[0] / t
        density_proxy = (gates.sum(dim=0) + others) / t
        return before[0], before[1], total1, density, density_proxy


def _moe_mlp_sharded(cfg: MixtralConfig, y: torch.Tensor, view, mesh
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_moe_mlp`` on a mesh, computing what JAX's computes on the whole
    batch (its SPMD partition does not change the function): this
    process's (B / data ranks, S) rows in, their MoE output and the
    global aux loss out.

    Routing runs on this rank's tokens with the whole batch's capacity,
    positions and means (``_BatchShare``). The dispatch fills only this
    rank's experts' slots (its ``E / ep`` experts: the expert tensors stay
    split over ``ep``), and the slots are summed over the data axes (each
    slot holds at most one token; the gradient is summed back the same
    way). The experts run on the local weights (on a tp-split view, on
    the rank's ``mlp`` columns); the combine reads this rank's tokens
    from its experts' slots, and the partial outputs are summed over tp
    and ep. The inputs of that split work, the tokens dispatched and the
    gates the combine weights are read from, sum their gradients over tp
    and ep; the router and the aux loss see them whole, once."""
    b, s, d = y.shape
    e = cfg.n_experts
    share = _BatchShare(mesh)
    t_local = b * s
    cap = capacity(cfg, t_local * share.n)
    e_local = view.w_gate.shape[0]
    ep = mesh_lib.axis_size(mesh, mesh_lib.EP)
    if e_local == e:
        lo, groups = 0, [view.tp_group]
    elif e_local * ep == e:
        lo = mesh_lib.axis_index(mesh, mesh_lib.EP) * e_local
        groups = [view.tp_group, mesh_lib.axis_group(mesh, mesh_lib.EP)]
    else:
        raise ValueError(f"n_experts={e} not divisible by ep={ep}")

    def split_input(t):
        for g in groups:
            t = placement.group_copy(t, g)
        return t

    gates = router_gates(y, view)
    dispatch, combine, aux = _top2_dispatch(
        gates, cap, share=share, combine_gates=split_input(gates), rows=b)
    mine = slice(lo, lo + e_local)
    yt = split_input(y.reshape(t_local, d))
    xs = (dispatch[:, mine].reshape(t_local, e_local * cap).to(y.dtype).t()
          @ yt).reshape(e_local, cap, d)
    for g in share.groups:
        xs = placement.group_copy(placement.group_reduce(xs, g), g)
    gate = F.silu(torch.bmm(xs, view.w_gate))
    up = torch.bmm(xs, view.w_up)
    out = torch.bmm(gate * up, view.w_down)
    yo = (combine[:, mine].reshape(t_local, e_local * cap).to(y.dtype)
          @ out.reshape(e_local * cap, d))
    for g in groups:
        yo = placement.group_reduce(yo, g)
    return yo.reshape(b, s, d), aux


def _view_layer(cfg: MixtralConfig, lp: nn.Module, x: torch.Tensor,
                positions: torch.Tensor, pair
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer on the (mesh, rules) ``pair``: its weights
    through llama's ``LayerView`` (gathered over the data axes at use,
    tp-split products kept split, the experts kept on their ep rank),
    llama's attention block, then ``_moe_mlp_sharded``. Under
    ``cfg.remat`` the view is inside the checkpoint, which enters the
    mesh itself: its recompute runs in the backward."""
    mesh = pair[0]

    def run(x, positions):
        with mesh_lib.use_mesh(*pair):
            view = llama.LayerView(cfg, lp, mesh)
            x = llama.attention_block(cfg, x, view, positions)
            y = llama.rms_norm(x, view.mlp_norm, cfg.norm_eps)
            moe_out, aux = _moe_mlp_sharded(cfg, y, view, mesh)
            return x + moe_out, aux

    if cfg.remat:
        return checkpoint(run, x, positions, use_reentrant=False)
    return run(x, positions)


def _forward_sharded(cfg: MixtralConfig, params: MixtralParams,
                     tokens: torch.Tensor, positions: torch.Tensor, pair):
    """The forward on a mesh: this process's (B, S) batch shard in, its
    fp32 logits and the global aux loss out (``forward``'s scaling).
    Parameters are read through ``placement.compute_view``; each layer is
    ``_view_layer``."""
    mesh = pair[0]
    if mesh_lib.axis_size(mesh, mesh_lib.PP) > 1:
        raise NotImplementedError(
            "Mixtral on a mesh with pp > 1: there is no pipelined Mixtral "
            "forward (the JAX package has none either); dp, fsdp, sp, ep "
            "and tp are supported")
    tokens, positions = seq_gather.seq_chunk(mesh, tokens, positions)
    x = llama.embed_tokens(params, tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.layers:
        x, aux = _view_layer(cfg, lp, x, positions, pair)
        aux_total = aux_total + aux
    logits = llama.lm_head(cfg, params, x)
    return logits, cfg.router_aux_weight * aux_total / cfg.n_layers


# ------------------------------------------------------ int8 serving tree

def _quantize_into(dst: nn.Module, src: nn.Module, name: str,
                   axis: int) -> None:
    """``dst.<name>`` and ``dst.<name>_scale``: llama's per-channel int8
    of ``src.<name>`` over ``axis``; an expert tensor (E, K, M) one expert
    at a time, so that the f32 temporaries are one expert's (the scale
    is per expert and channel, so the result is the whole tensor's)."""
    w = getattr(src, name)
    if w.dim() == 3:
        parts = [llama._quantize_weight(w[e], axis)
                 for e in range(w.shape[0])]
        codes = torch.stack([c for c, _ in parts])
        scale = torch.stack([sc for _, sc in parts])
    else:
        codes, scale = llama._quantize_weight(w, axis)
    setattr(dst, name, llama._frozen(codes))
    setattr(dst, name + "_scale", llama._frozen(scale))


def _quantized_layer(cfg: MixtralConfig, src: MixtralLayer) -> MixtralLayer:
    """One layer of :func:`quantize_params`' tree; the norms and the f32
    router are ``src``'s own tensors."""
    dst = MixtralLayer(cfg, "meta", cfg.dtype)
    for name in ("attn_norm", "mlp_norm", "router"):
        setattr(dst, name, getattr(src, name))
    for name in llama.QUANT_LAYER_WEIGHTS:
        _quantize_into(dst, src, name, -2)
    return dst


@torch.no_grad()
def quantize_params(cfg: MixtralConfig, params: MixtralParams
                    ) -> MixtralParams:
    """The int8 serving tree: llama's per-output-channel scheme over the
    attention weights and the expert tensors (the in-features axis is
    always -2, so the expert axis survives into the scale: (E, out)),
    the embed table per row. The f32 router stays exact: routing is a
    discrete argmax that quantization noise must not move. Norms and the
    router are shared with ``params``, not copied. Each tensor is
    quantized and its f32 temporaries freed before the next."""
    out = MixtralParams(cfg, "meta", cfg.dtype)
    for name, axis in (("embed", -1), ("lm_head", -2)):
        _quantize_into(out, params, name, axis)
    out.final_norm = params.final_norm
    for i, src in enumerate(params.layers):
        out.layers[i] = _quantized_layer(cfg, src)
    return out


params_quantized = llama.params_quantized


# ----------------------------------------------------------- KV-cache decode

def _top2_weights(gates: torch.Tensor) -> torch.Tensor:
    """(..., E) softmax gates -> (..., E) combine weights: exactly two
    experts, picked as ``lax.top_k`` picks them (the larger gate first,
    ties toward the lower index: two first-max argmaxes, the winner masked
    to -inf for the second), their gates renormalised to sum to one in
    the gates' f32. A value threshold would take three or more experts on
    tied gates and part from the capacity path."""
    e = gates.shape[-1]
    first = F.one_hot(gates.argmax(dim=-1), e).bool()
    second = F.one_hot(
        gates.masked_fill(first, float("-inf")).argmax(dim=-1), e).bool()
    w = gates * (first | second)
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)


def _expert_mm(x: torch.Tensor, lp: nn.Module, name: str) -> torch.Tensor:
    """x (N, K) or (E, N, K) against every expert's ``name`` (E, K, M):
    (E, N, M). An int8 weight's codes are cast to x's dtype for the
    product, and its per-(expert, channel) f32 scale multiplies the
    result in fp32 before the cast back, as the JAX package rounds it."""
    w = getattr(lp, name)
    scale = getattr(lp, name + "_scale", None)
    if scale is None:
        return torch.matmul(x, w)
    r = torch.matmul(x, w.to(x.dtype))
    return (r.float() * scale[:, None, :]).to(x.dtype)


def _moe_mlp_dense(cfg: MixtralConfig, y: torch.Tensor,
                   lp: nn.Module) -> torch.Tensor:
    """Inference-time MoE, y (B, T, D) -> (B, T, D): every expert computed
    on every token, the top-2 combined with their renormalised gates
    (cast to the activations' dtype first, as the JAX einsum takes
    them). Experts run as one batched product over E, each on all B * T
    tokens."""
    b, t, d = y.shape
    yt = y.reshape(b * t, d)
    w = _top2_weights(router_gates(y, lp))                      # (N, E)
    gate = F.silu(_expert_mm(yt, lp, "w_gate"))                 # (E, N, M)
    up = _expert_mm(yt, lp, "w_up")
    out = _expert_mm(gate * up, lp, "w_down")                   # (E, N, D)
    return torch.einsum("ne,end->nd", w.to(out.dtype), out).reshape(b, t, d)


def _moe_block(cfg: MixtralConfig, x: torch.Tensor,
               lp: nn.Module) -> torch.Tensor:
    """Pre-norm dense-routed MoE residual block (inference). On a
    tp-split layer view each rank runs every expert on its ``mlp``
    columns (the router is whole, so every rank routes alike), and the
    combined partial outputs are summed over tp."""
    y = llama.rms_norm(x, lp.mlp_norm, cfg.norm_eps)
    return x + placement.group_reduce(_moe_mlp_dense(cfg, y, lp),
                                   llama._tp_group(lp))


# Llama's cache layouts and specs: the attention blocks are shared and
# experts add no per-token state.
init_cache = llama.init_cache
init_paged_cache = llama.init_paged_cache
cache_specs = llama.cache_specs
paged_cache_specs = llama.paged_cache_specs


def forward_with_cache(cfg: MixtralConfig, params: MixtralParams,
                       tokens: torch.Tensor, cache, start_pos,
                       valid_len=None, logits_at=None, *,
                       block: Optional[int] = None):
    """llama's incremental forward (its scalar-or-(B,) start_pos /
    valid_len / logits_at contract) with the MoE block as the MLP."""
    return llama.forward_with_cache(
        cfg, params, tokens, cache, start_pos, valid_len=valid_len,
        logits_at=logits_at, block=block, mlp_fn=_moe_block)


def forward_with_paged_cache(cfg: MixtralConfig, params: MixtralParams,
                             tokens: torch.Tensor, cache, table, start_pos,
                             valid_len=None, logits_at=None, *,
                             window: int, write_block: Optional[int] = None):
    """llama's paged incremental forward with the MoE block."""
    return llama.forward_with_paged_cache(
        cfg, params, tokens, cache, table, start_pos, valid_len=valid_len,
        logits_at=logits_at, window=window, write_block=write_block,
        mlp_fn=_moe_block)


def verify_step(cfg: MixtralConfig, params: MixtralParams,
                tokens: torch.Tensor, cache, start_pos, spec_len, *,
                block: Optional[int] = None):
    """llama's dense speculative verify window with the MoE block: routing
    is per token, so a verify column's logits equal the 1-token step's."""
    return llama.verify_step(cfg, params, tokens, cache, start_pos,
                             spec_len, block=block, mlp_fn=_moe_block)


def verify_step_paged(cfg: MixtralConfig, params: MixtralParams,
                      tokens: torch.Tensor, cache, table, start_pos,
                      spec_len, *, window: int):
    """llama's paged speculative verify window with the MoE block."""
    return llama.verify_step_paged(cfg, params, tokens, cache, table,
                                   start_pos, spec_len, window=window,
                                   mlp_fn=_moe_block)


def decode(cfg: MixtralConfig, params: MixtralParams, prompt: torch.Tensor,
           true_len, max_tokens: int, max_seq: int,
           temperature: float = 0.0, key: Optional[torch.Tensor] = None, *,
           cache=None) -> torch.Tensor:
    """Prefill + cached decode (llama's loop with the MoE block plugged
    in; scalar or ragged (B,) ``true_len``)."""
    return llama.decode(cfg, params, prompt, true_len, max_tokens, max_seq,
                        temperature=temperature, key=key, cache=cache,
                        mlp_fn=_moe_block)
