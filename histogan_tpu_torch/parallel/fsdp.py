"""Fully sharded training state (ZeRO-3) over the data-parallel ranks, the
counterpart of ``histogan_tpu/parallel/fsdp.py``.

The JAX package lays every state leaf out sharded along one dimension of
the 'data' mesh axis and lets XLA insert the weight all-gathers and the
gradient reduce-scatters. Here the collectives are written out, because
the port takes its gradients with ``torch.autograd.grad`` (the gradient
penalty is a double backward), which no hook-based FSDP sees:

- ``shard_module_`` replaces each parameter that ``fsdp_spec`` shards by
  this rank's slice of it: the fp32 masters, and so DiffGrad's state
  (made in the parameters' shapes), and the EMA copies SE/HE/GE. The
  other parameters (odd widths, scalars) and every buffer (the VQ
  codebook) stay whole on every rank;
- before a phase, ``gather_parameters`` all-gathers the full parameters
  of the modules it runs (plain tensors, with no autograd link to the
  shards), which the phase runs through ``torch.func.functional_call``;
- after a phase, ``reduce_gradients_`` reduce-scatters the full gradients
  of the sharded parameters onto the shards (sum, then divide by the
  world size) and averages the others as data parallel does, and
  DiffGrad steps the shards;
- ``unshard_state_dict`` and ``full_optimizer_state_dict`` gather a
  checkpoint's full state, on every rank; ``load_state_dict_`` and
  ``load_optimizer_state_dict_`` take a full one and keep this rank's
  slices. A checkpoint file is always the full state.

Every collective moves one flat buffer (per dtype for a sum), not one per
tensor. At world size 1 nothing is sharded, and every function is the
replicated path.

The layout rule (``fsdp_spec``) is the JAX package's, on the same logical
axis: shard the largest dimension the world size divides, the trailing one
winning ties, counted in the JAX layout (HWIO convolutions, (in, out)
linears, the (4, 4, C) initial block), which the port's OIHW, (out, in)
and (C, 4, 4) parameters are a transpose of.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from histogan_tpu_torch.parallel import mesh

# per rank of a port parameter, the port axis of each axis of its JAX layout
JAX_AXES = {4: (2, 3, 1, 0),  # OIHW -> HWIO
            3: (1, 2, 0),  # the initial block (C, 4, 4) -> (4, 4, C)
            2: (1, 0)}  # Linear (out, in) -> (in, out)


class Leaf(NamedTuple):
    """A sharded parameter: the axis it is split along, and its full shape."""

    dim: int
    shape: Tuple[int, ...]


def fsdp_spec(shape: Sequence[int], n: int) -> Optional[int]:
    """The port axis along which ``n`` ranks shard a parameter of ``shape``:
    the largest dimension of its JAX layout that ``n`` divides, the
    trailing one winning ties (``fsdp_spec``, fsdp.py:36-47); None (stays
    whole) where none does."""
    axes = JAX_AXES.get(len(shape), tuple(range(len(shape))))
    jax_shape = [shape[a] for a in axes]
    best = None
    for i, d in enumerate(jax_shape):
        if d > 0 and d % n == 0 and (best is None or d >= jax_shape[best]):
            best = i
    return None if best is None else axes[best]


def plan(module: nn.Module) -> Dict[str, Leaf]:
    """{parameter name: Leaf} of the parameters ``module`` holds sharded."""
    return getattr(module, "fsdp_plan", {})


def local_part(full: torch.Tensor, leaf: Optional[Leaf]) -> torch.Tensor:
    """This rank's slice of ``full`` under ``leaf`` (``full`` for None)."""
    if leaf is None:
        return full
    k = leaf.shape[leaf.dim] // mesh.world_size()
    return full.narrow(leaf.dim, mesh.rank() * k, k)


@torch.no_grad()
def shard_module_(module: nn.Module) -> nn.Module:
    """Replace each parameter of ``module`` that ``fsdp_spec`` shards over
    the world by this rank's slice (a contiguous copy), and record the
    layout in ``module.fsdp_plan``. Nothing changes at world size 1. Call
    it before an optimizer is built over the parameters."""
    n, layout = mesh.world_size(), {}
    if n > 1:
        for name, p in list(module.named_parameters()):
            dim = fsdp_spec(p.shape, n)
            if dim is None:
                continue
            leaf = Leaf(dim, tuple(p.shape))
            owner_name, _, attr = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            owner._parameters[attr] = nn.Parameter(
                local_part(p, leaf).clone(memory_format=torch.contiguous_format),
                requires_grad=p.requires_grad)
            layout[name] = leaf
    module.fsdp_plan = layout
    return module


def gather(shards: Sequence[torch.Tensor], leaves: Sequence[Leaf]) -> List[torch.Tensor]:
    """The full tensors of ``shards`` (this rank's slices under ``leaves``),
    on their device: one all-gather of their bytes, whatever their dtypes."""
    if not shards:
        return []
    n = mesh.world_size()
    flat = torch.cat([s.detach().contiguous().reshape(-1).view(torch.uint8) for s in shards])
    rows = mesh.all_gather(flat).view(n, -1)  # rank q's bytes in row q
    out, off = [], 0
    for s, leaf in zip(shards, leaves):
        size = s.numel() * s.element_size()
        parts = rows[:, off:off + size].contiguous().view(s.dtype).view(n, *s.shape)
        out.append(parts.movedim(0, leaf.dim).reshape(leaf.shape))
        off += size
    return out


def reduce_scatter_mean(fulls: Sequence[torch.Tensor], dims: Sequence[int]) -> List[torch.Tensor]:
    """This rank's slice of the mean over the ranks of each full tensor of
    ``fulls``, split along its entry of ``dims``: one reduce-scatter (sum)
    per dtype, then the division by the world size, as ``all_reduce_mean_``
    divides its sum."""
    n = mesh.world_size()
    out: List[Optional[torch.Tensor]] = [None] * len(fulls)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, f in enumerate(fulls):
        by_dtype.setdefault(f.dtype, []).append(i)
    for idx in by_dtype.values():
        chunks = [[f.chunk(n, dim=d)[q] for f, d in ((fulls[i], dims[i]) for i in idx)]
                  for q in range(n)]
        flat = torch.cat([c.reshape(-1) for per_rank in chunks for c in per_rank])
        mine = mesh.reduce_scatter(flat)
        mine.div_(n)
        for i, c, v in zip(idx, chunks[0], mine.split([c.numel() for c in chunks[0]])):
            out[i] = v.view(c.shape)
    return out


def gather_parameters(modules: Sequence[nn.Module]) -> List[Optional[Dict[str, torch.Tensor]]]:
    """For each sharded module of ``modules`` its parameters by name, full
    size (the sharded ones gathered: new leaf tensors that, in grad mode,
    require a gradient as their shards do; the others the module's own), in one
    all-gather; None for a module that is not sharded."""
    wanted = [(i, name, leaf) for i, m in enumerate(modules) for name, leaf in plan(m).items()]
    own = [dict(m.named_parameters()) if plan(m) else None for m in modules]
    fulls = gather([own[i][name] for i, name, _ in wanted], [leaf for _, _, leaf in wanted])
    out = [None if p is None else dict(p) for p in own]
    grad = torch.is_grad_enabled()
    for (i, name, _), full in zip(wanted, fulls):
        out[i][name] = full.requires_grad_(grad and own[i][name].requires_grad)
    return out


def phase_parameters(modules: Sequence[nn.Module],
                     gathered: Sequence[Optional[Dict[str, torch.Tensor]]]) -> List[torch.Tensor]:
    """The tensors a phase takes its gradients with respect to, in the
    order of the modules' parameters (DiffGrad's): the gathered ones of a
    sharded module, the parameters themselves of one that is not."""
    return [t for m, g in zip(modules, gathered)
            for t in (m.parameters() if g is None else g.values())]


def reduce_gradients_(params: Sequence[torch.Tensor], grads: List[torch.Tensor]) -> None:
    """Average a phase's ``grads`` (full size) across the ranks into the
    gradients of ``params`` (what DiffGrad steps), in place in the list: a
    sharded parameter's (its shard smaller than its gradient) reduce-
    scattered onto its slice, so the list lets its full gradient go, the
    others all-reduced in place as data parallel does."""
    sharded = [i for i, (p, g) in enumerate(zip(params, grads)) if p.shape != g.shape]
    whole = sorted(set(range(len(grads))) - set(sharded))
    mesh.all_reduce_mean_([grads[i] for i in whole])
    if sharded:
        n = mesh.world_size()
        shards = reduce_scatter_mean([grads[i] for i in sharded],
                                     [fsdp_spec(grads[i].shape, n) for i in sharded])
        for i, s in zip(sharded, shards):
            grads[i] = s


def unshard_state_dict(modules: Dict[str, nn.Module]) -> Dict[str, torch.Tensor]:
    """The flat reference-layout state dict ``{prefix.name: tensor}`` of
    ``modules`` ({prefix: module}), every sharded parameter gathered to its
    full shape in one all-gather. A collective where a module is sharded:
    every rank calls it, and every rank gets the whole dict."""
    wanted = [(p, name, leaf) for p, m in modules.items() for name, leaf in plan(m).items()]
    sds = {p: m.state_dict() for p, m in modules.items()}
    fulls = gather([sds[p][name] for p, name, _ in wanted], [leaf for _, _, leaf in wanted])
    for (p, name, _), full in zip(wanted, fulls):
        sds[p][name] = full
    return {f"{p}.{k}": v for p, sd in sds.items() for k, v in sd.items()}


def load_state_dict_(module: nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Load the full state dict ``sd`` into ``module`` strictly, keeping this
    rank's slice of each sharded parameter."""
    layout = plan(module)
    module.load_state_dict({k: local_part(v, layout.get(k)) for k, v in sd.items()},
                           strict=True)


def param_leaves(modules: Sequence[nn.Module]) -> List[Optional[Leaf]]:
    """The Leaf (or None) of each parameter of ``modules``, in the order of
    their parameters: an optimizer's over them."""
    return [plan(m).get(name) for m in modules for name, _ in m.named_parameters()]


def full_optimizer_state_dict(opt: torch.optim.Optimizer, modules: Sequence[nn.Module]) -> dict:
    """``opt.state_dict()`` (an optimizer over the parameters of
    ``modules``, in their order) with each per-parameter tensor of a
    sharded parameter gathered to its full shape, in one all-gather; a
    collective, as ``unshard_state_dict``."""
    sd = opt.state_dict()
    leaves = param_leaves(modules)
    wanted = [(i, k) for i, s in sd["state"].items() if leaves[i] is not None
              for k, v in s.items() if torch.is_tensor(v) and v.dim() > 0]
    fulls = gather([sd["state"][i][k] for i, k in wanted], [leaves[i] for i, _ in wanted])
    state = {i: dict(s) for i, s in sd["state"].items()}
    for (i, k), full in zip(wanted, fulls):
        state[i][k] = full
    return {**sd, "state": state}


def load_optimizer_state_dict_(opt: torch.optim.Optimizer, sd: dict,
                               modules: Sequence[nn.Module]) -> None:
    """Load a full optimizer state dict (``full_optimizer_state_dict``'s, or
    a replicated run's) into ``opt``, keeping this rank's slices."""
    leaves = param_leaves(modules)

    def mine(v, leaf):
        if leaf is None or not torch.is_tensor(v) or v.dim() == 0:
            return v
        return local_part(v, leaf).clone(memory_format=torch.contiguous_format)

    state = {i: {k: mine(v, leaves[i]) for k, v in s.items()} for i, s in sd["state"].items()}
    opt.load_state_dict({**sd, "state": state})


def sharded_bytes_per_rank(modules: Sequence[nn.Module],
                           optimizers: Sequence[torch.optim.Optimizer] = ()) -> int:
    """Bytes of training state this rank holds: the parameters and buffers
    of ``modules`` and the tensors of the optimizers' state (the memory
    diagnostic, ``sharded_bytes_per_device``; whole tensors count in full)."""
    tensors = [t for m in modules for t in (*m.parameters(), *m.buffers())]
    tensors += [v for opt in optimizers for s in opt.state.values() for v in s.values()
                if torch.is_tensor(v)]
    return sum(t.numel() * t.element_size() for t in tensors)
