"""Parameter placements: FSDP over ``data`` and tensor parallelism over
``model`` (port of parallel/partitioning.py).

A spec is a tuple with one entry per axis of a leaf, each an axis name or
None, equal to ``tuple(PartitionSpec(...))`` of the reference; ``()`` is
replicated. Specs are chosen on the reference's layout of each leaf, where
every per-layer tensor is stacked ``[L, in, out]``: the port keeps
per-layer ``nn.Linear`` weights ``[out, in]`` in a ``ModuleList``, and
``fsdp_spec``'s "largest divisible axis, the last on a tie" would pick
another axis on the transposed shape. So ``reference_shapes`` rebuilds the
reference's tree of shapes from a module (through ``models/weights.py``'s
name map), the placements below are nested dicts in that tree's layout,
and ``apply_shardings`` maps each chosen axis onto the port's tensors.

``apply_shardings`` places every tensor on the mesh's device and records
its spec in the port's axis order as ``tensor.sharding_spec`` (an axis
chosen on the stacked layer axis has no port dimension and is dropped).
That is all a mesh whose entries are one device needs. On a distributed
mesh (``torchrun``) it then applies the specs to the encoder's module.
A weight whose spec names ``model`` becomes a DTensor over the model axis
holding this rank's shard (``Shard(dim)``), which the forward runs
column- or row-parallel (``models/llama.py``). Then, where a spec names
``data``, FSDP2's ``fully_shard`` (each layer, then the root)
shards it ``Shard(dim)`` on the dim its spec names, over the data axis
(on top of the model split: a 2-D DTensor), the tensors without a data
axis left out (``ignored_params``). A single process over several
distinct cards raises: launch one process per card under ``torchrun``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
from torch.distributed.tensor import DTensor, Shard

from scaling_retriever_tpu_torch.models.deepseek_v2 import InferenceOnly
from scaling_retriever_tpu_torch.models.llama import LlamaBiForMNTP
from scaling_retriever_tpu_torch.models.t5 import T5ForConditionalGeneration
from scaling_retriever_tpu_torch.models.weights import _BIASES, _MATS
from scaling_retriever_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: tuple              # in the reference's layout of the leaf


def fsdp_spec(shape: tuple, n_shards: int, min_size: int = 2 ** 16,
              axis_name: str = "data") -> tuple:
    """The largest axis (the last on a tie) divisible by ``n_shards``;
    replicated below ``min_size`` elements or when none divides."""
    if n_shards <= 1 or int(np.prod(shape)) < min_size:
        return ()
    best = None
    for i in range(len(shape) - 1, -1, -1):
        if shape[i] % n_shards == 0:
            if best is None or shape[i] > shape[best]:
                best = i
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best] = axis_name
    return tuple(spec)


def _reference_leaves(params) -> dict:
    """{reference path: (reference shape, [(port tensor, axes)])}, where
    ``axes[j]`` is the port tensor's axis for the reference's axis j (None
    for the stacked layer axis). ``params`` is the port's module, or a
    nested dict of tensors already in the reference's layout (LoRA
    trees)."""
    if params is None:
        return {}
    if isinstance(params, dict):
        out = {}

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            else:
                out[path] = (tuple(node.shape),
                             [(node, tuple(range(node.ndim)))])

        walk(params, ())
        return out
    group_of = {name: group for group, name in _MATS}
    bias_of = {w: b for b, w in _BIASES}
    leaves: dict = {}
    for name, p in params.named_parameters():
        parts = name.split(".")
        owner = params.get_submodule(".".join(parts[:-1]))
        axes = tuple(range(p.ndim))
        if isinstance(owner, torch.nn.Linear) and parts[-1] == "weight":
            axes = axes[::-1]                    # [out, in] ↔ [in, out]
        shape = tuple(p.shape[a] for a in axes)
        if "layers" in parts:
            at = parts.index("layers")
            mod, leaf = parts[at + 2], parts[at + 2]
            if parts[-1] == "bias":
                leaf = bias_of[mod]
            group = (group_of[mod],) if mod in group_of else ()
            path = (*parts[:at], "layers", *group, leaf)
            stack = leaves.setdefault(path, [(0, *shape), []])
            stack[0] = (stack[0][0] + 1, *shape)
            stack[1].append((p, (None, *axes)))
        else:
            path = tuple(parts[:-1] if parts[-1] == "weight" else parts)
            leaves[path] = [shape, [(p, axes)]]
    return {path: tuple(v) for path, v in leaves.items()}


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, tree


def reference_shapes(params) -> dict:
    """The reference's tree of leaf shapes for ``params``."""
    return _nest({p: s for p, (s, _) in _reference_leaves(params).items()})


def fsdp_shardings(params, mesh: Mesh, axis_name: str = "data",
                   min_size: int = 2 ** 16) -> dict:
    """A ``NamedSharding`` per leaf, in the reference's layout."""
    n = mesh.shape[axis_name]
    return _nest({p: NamedSharding(mesh, fsdp_spec(s, n, min_size,
                                                   axis_name))
                  for p, s in _flatten(reference_shapes(params))})


def replicated_shardings(params, mesh: Mesh) -> dict:
    return _nest({p: NamedSharding(mesh, ())
                  for p, _ in _flatten(reference_shapes(params))})


# Tensor-parallel axis per stacked parameter [L, in, out]: Megatron-style
# column-parallel QKV/gate/up (shard the output dim), row-parallel O/down
# (shard the input dim)
_TP_AXIS = {
    ("attn", "wq"): 2, ("attn", "wk"): 2, ("attn", "wv"): 2,
    ("attn", "wo"): 1,
    ("attn", "bq"): 1, ("attn", "bk"): 1, ("attn", "bv"): 1,
    ("mlp", "wg"): 2, ("mlp", "wu"): 2, ("mlp", "wd"): 1,
}


def model_parallel_shardings(params, mesh: Mesh, fsdp: bool = False,
                             data_axis: str = "data",
                             model_axis: str = "model",
                             min_size: int = 2 ** 16) -> dict:
    """Specs combining TP over ``model`` with optional FSDP over ``data``
    (on another tensor axis), for the decoder-only layout. Non-layer
    tensors (embeddings, norms, lm_head) follow the FSDP rule or stay
    replicated."""
    n_model = mesh.shape[model_axis]
    n_data = mesh.shape[data_axis]

    def layer_spec(group, name, shape):
        dims = [None] * len(shape)
        tp_dim = _TP_AXIS.get((group, name))
        if n_model > 1 and tp_dim is not None and tp_dim < len(shape) \
                and shape[tp_dim] % n_model == 0:
            dims[tp_dim] = model_axis
        if fsdp and n_data > 1:
            # shard the largest remaining dim over data
            cands = [i for i in range(len(shape)) if dims[i] is None
                     and i != 0 and shape[i] % n_data == 0]
            if cands and int(np.prod(shape)) >= min_size:
                dims[max(cands, key=lambda i: shape[i])] = data_axis
        return NamedSharding(mesh, tuple(dims))

    def flat_spec(shape):
        return NamedSharding(mesh, fsdp_spec(shape, n_data, min_size,
                                             data_axis) if fsdp else ())

    out: dict = {}
    for key, val in reference_shapes(params).items():
        if key == "layers":
            out[key] = {
                group: ({name: ({k: NamedSharding(mesh, ()) for k in arr}
                                if isinstance(arr, dict)    # LoRA factors
                                else layer_spec(group, name, arr))
                         for name, arr in sub.items()}
                        if isinstance(sub, dict) else flat_spec(sub))
                for group, sub in val.items()}
        elif isinstance(val, dict):
            raise ValueError(f"tensor parallelism covers the decoder-only "
                             f"layout; {key!r} is a stack of its own")
        else:
            out[key] = flat_spec(val)
    return out


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (dev.index is None
                                          or t.device.index == dev.index)


def apply_shardings(params, shardings: dict):
    """``params`` (module or nested dict) on the mesh's device, each tensor
    with its spec in the port's axis order as ``sharding_spec``. A dict's
    tensor that moves keeps its ``requires_grad``."""
    if isinstance(params, InferenceOnly):
        params.refuse("sharding")
    flat = dict(_flatten(shardings))
    if not flat:
        return params
    mesh = next(iter(flat.values())).mesh
    if mesh.distinct:
        raise NotImplementedError(
            "one process places parameters on one card: to train over "
            "several cards, launch one process per card under torchrun "
            "(torch.distributed)")
    dev = mesh.device
    if isinstance(params, torch.nn.Module):
        params = params.to(dev)
    else:
        params = _nest({
            p: t if _on(t, dev) else
            t.detach().to(dev).requires_grad_(t.requires_grad)
            for p, t in _flatten(params)})
    for path, (_, targets) in _reference_leaves(params).items():
        spec = flat[path].spec
        for t, axes in targets:
            port = [None] * t.ndim
            for j, name in enumerate(spec):
                if name is not None and axes[j] is not None:
                    port[axes[j]] = name
            t.sharding_spec = tuple(port)
    if mesh.distributed:
        _distribute(params, mesh)
    return params


def _sharded_axes(params) -> set:
    tensors = (params.parameters() if isinstance(params, torch.nn.Module)
               else (t for _, t in _flatten(params)))
    return {a for t in tensors for a in t.sharding_spec if a is not None}


def _distribute(params, mesh: Mesh) -> None:
    """Apply the recorded specs over the ranks (see the module's
    docstring), in place."""
    axes = _sharded_axes(params)
    if not axes:
        return
    if not isinstance(params, (LlamaBiForMNTP, T5ForConditionalGeneration)):
        raise NotImplementedError(
            f"sharding a {type(params).__name__} over ranks: only an "
            f"encoder's module (the Llama family's or T5's) shards over "
            f"ranks; a tree of tensors stays replicated")
    if "model" in axes:
        _tensor_parallel(params, mesh)
    if "data" in axes:
        _fully_shard(params, mesh)


def _fully_shard(module, mesh: Mesh) -> None:
    if isinstance(module, LlamaBiForMNTP):
        layers = list(module.layers)
        methods = ("forward_hidden", "forward_logits")
    else:
        layers = [*module.encoder.layers, *module.decoder.layers]
        methods = ("encode", "forward_logits")
    specs = {n: p.sharding_spec for n, p in module.named_parameters()}
    ignored = {p for p in module.parameters() if "data" not in
               p.sharding_spec}

    def place(p):
        return Shard(p.sharding_spec.index("data"))

    kw = dict(mesh=mesh.device_mesh["data"], shard_placement_fn=place,
              ignored_params=ignored)
    for layer in layers:
        fully_shard(layer, **kw)
    fully_shard(module, **kw)
    # the encoders call these methods, not forward: the root's hooks
    # must gather its parameters around them
    for method in methods:
        register_fsdp_forward_method(module, method)
    for n, p in module.named_parameters():
        p.sharding_spec = specs[n]


def _tensor_parallel(module: LlamaBiForMNTP, mesh: Mesh) -> None:
    cfg, n_model = module.config, mesh.shape["model"]
    if cfg.num_attention_heads % n_model or \
            cfg.num_key_value_heads % n_model:
        raise NotImplementedError(
            f"tensor parallelism over {n_model} ranks splits whole heads: "
            f"{cfg.num_attention_heads} query and "
            f"{cfg.num_key_value_heads} kv heads")
    rank = mesh.coordinate("model")
    for layer in module.layers:
        for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
            lin = getattr(layer, name)
            for leaf in ("weight", "bias"):
                p = getattr(lin, leaf)
                if p is None:
                    continue
                if "model" not in p.sharding_spec:
                    raise NotImplementedError(
                        f"{name}.{leaf} {tuple(p.shape)} does not split "
                        f"over {n_model} ranks")
                dim = p.sharding_spec.index("model")
                n = p.shape[dim] // n_model
                local = p.detach().narrow(dim, rank * n, n).contiguous()
                new = torch.nn.Parameter(
                    DTensor.from_local(local, mesh.device_mesh["model"],
                                       [Shard(dim)], run_check=False),
                    requires_grad=p.requires_grad)
                new.sharding_spec = p.sharding_spec
                setattr(lin, leaf, new)


def shard_audit(params, shardings: dict, min_size: int = 2 ** 16) -> dict:
    """Parameter bytes in all and under a spec that shards, and the leaves
    of at least ``min_size`` elements that stay whole (path, shape)."""
    flat = dict(_flatten(shardings))
    total = sharded = 0
    unsharded_big = []
    for path, (shape, targets) in _reference_leaves(params).items():
        nbytes = sum(t.numel() * t.element_size() for t, _ in targets)
        total += nbytes
        if any(ax is not None for ax in flat[path].spec):
            sharded += nbytes
        elif int(np.prod(shape)) >= min_size:
            unsharded_big.append((".".join(path), shape))
    return {"param_bytes_total": total, "param_bytes_sharded": sharded,
            "unsharded_big": unsharded_big}
