"""Parameter conversion from the JAX package's GPT to the port's.

``gpt_params_from_jax`` takes the flax parameter tree of
``horovod_tpu.models.GPT`` as numpy arrays (``jax.tree_util.tree_map(
np.asarray, variables)``) and returns a ``state_dict`` for
``horovod_tpu_torch.models.GPT``; ``gpt_params_to_jax`` maps the port's
parameters, or their gradients, back onto the flax layout.  Layouts:

- ``qkv.kernel`` ``[hidden, 3, H, D]`` -> ``weight = kernel.reshape(hidden,
  -1).T``; bias ``[3, H, D]`` -> ``bias.reshape(-1)``;
- ``out.kernel`` ``[H, D, hidden]`` -> ``weight = kernel.reshape(H*D,
  hidden).T``;
- a ``Dense`` kernel ``[in, out]`` -> ``weight = kernel.T``;
- ``Embed.embedding`` and LayerNorm ``scale``/``bias`` keep their layout
  (``scale`` becomes ``weight``); ``lm_head`` has no bias.

``from_jax`` and ``to_jax`` do the same for the rest of the zoo (MLP,
ResNet, VGG, Inception V3, BERT), whose torch modules carry the flax
names, so a flax path ``a/b/kernel`` is the torch key ``a.b.weight``:

| flax leaf | torch |
|---|---|
| Conv ``kernel`` HWIO | ``weight`` OIHW |
| Dense ``kernel`` ``[in, out]`` | ``weight`` ``[out, in]`` |
| DenseGeneral ``qkv`` ``[hidden, 3, heads, hd]`` | ``weight`` ``[3 * heads * hd, hidden]``, (3, heads, hd) order |
| DenseGeneral ``out`` ``[heads, hd, hidden]`` | ``weight`` ``[hidden, heads * hd]`` |
| ``bias`` (any shape) | ``bias``, flattened |
| BatchNorm and LayerNorm ``scale``, Embed ``embedding`` | ``weight`` |
| ``batch_stats`` ``mean``/``var`` | ``running_mean``/``running_var`` |
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tree(params) -> dict:
    return params["params"] if "params" in params else params


def _dense(tree, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    kernel = np.asarray(tree["kernel"])
    out[f"{prefix}.weight"] = torch.from_numpy(
        kernel.reshape(kernel.shape[0], -1).T.copy())
    if "bias" in tree:
        out[f"{prefix}.bias"] = torch.from_numpy(
            np.asarray(tree["bias"]).reshape(-1).copy())


def _ln(tree, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = torch.from_numpy(np.array(tree["scale"]))
    out[f"{prefix}.bias"] = torch.from_numpy(np.array(tree["bias"]))


def gpt_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """flax GPT parameters (numpy leaves) -> the port's ``state_dict``."""
    tree = _tree(params)
    out: Dict[str, torch.Tensor] = {}
    out["wte.weight"] = torch.from_numpy(np.array(tree["wte"]["embedding"]))
    out["wpe.weight"] = torch.from_numpy(np.array(tree["wpe"]["embedding"]))
    n_layers = sum(1 for k in tree if k.startswith("h_"))
    for i in range(n_layers):
        blk, pre = tree[f"h_{i}"], f"h.{i}"
        _ln(blk["ln_1"], f"{pre}.ln_1", out)
        _dense(blk["attn"]["qkv"], f"{pre}.attn.qkv", out)
        heads, head_dim, hidden = np.asarray(
            blk["attn"]["out"]["kernel"]).shape
        out_kernel = np.asarray(blk["attn"]["out"]["kernel"]).reshape(
            heads * head_dim, hidden)
        out[f"{pre}.attn.out.weight"] = torch.from_numpy(out_kernel.T.copy())
        out[f"{pre}.attn.out.bias"] = torch.from_numpy(
            np.array(blk["attn"]["out"]["bias"]))
        _ln(blk["ln_2"], f"{pre}.ln_2", out)
        _dense(blk["mlp_in"], f"{pre}.mlp_in", out)
        _dense(blk["mlp_out"], f"{pre}.mlp_out", out)
    _ln(tree["ln_f"], "ln_f", out)
    _dense(tree["lm_head"], "lm_head", out)
    return out


def gpt_params_to_jax(named: Dict[str, torch.Tensor], like) -> dict:
    """The port's per-parameter tensors (parameters or gradients, under
    ``state_dict`` keys) -> numpy arrays in the flax tree layout of
    ``like`` (a flax parameter tree)."""
    tree = _tree(like)

    def get(key):
        return named[key].detach().cpu().numpy()

    def dense(sub, prefix):
        res = {"kernel": get(f"{prefix}.weight").T.reshape(
            np.shape(sub["kernel"]))}
        if "bias" in sub:
            res["bias"] = get(f"{prefix}.bias").reshape(np.shape(sub["bias"]))
        return res

    def ln(prefix):
        return {"scale": get(f"{prefix}.weight"), "bias": get(f"{prefix}.bias")}

    out = {"wte": {"embedding": get("wte.weight")},
           "wpe": {"embedding": get("wpe.weight")},
           "ln_f": ln("ln_f"), "lm_head": dense(tree["lm_head"], "lm_head")}
    for name, blk in tree.items():
        if not name.startswith("h_"):
            continue
        pre = "h." + name[2:]
        out[name] = {
            "ln_1": ln(f"{pre}.ln_1"), "ln_2": ln(f"{pre}.ln_2"),
            "attn": {"qkv": dense(blk["attn"]["qkv"], f"{pre}.attn.qkv"),
                     "out": dense(blk["attn"]["out"], f"{pre}.attn.out")},
            "mlp_in": dense(blk["mlp_in"], f"{pre}.mlp_in"),
            "mlp_out": dense(blk["mlp_out"], f"{pre}.mlp_out"),
        }
    return out


_STATS = {"mean": "running_mean", "var": "running_var"}
_WEIGHT = ("kernel", "scale", "embedding")


def _leaves(tree, path=()):
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def _torch_key(path, collection: str) -> str:
    *mods, leaf = path
    if collection == "batch_stats":
        leaf = _STATS[leaf]
    elif leaf in _WEIGHT:
        leaf = "weight"
    return ".".join([*mods, leaf])


def _kernel_to_torch(path, k: np.ndarray) -> np.ndarray:
    if path[-2] == "qkv":                   # [hidden, 3, heads, hd]
        return k.reshape(k.shape[0], -1).T
    if k.ndim == 4:                         # conv HWIO -> OIHW
        return k.transpose(3, 2, 0, 1)
    return k.reshape(-1, k.shape[-1]).T     # Dense, DenseGeneral "out"


def _kernel_to_jax(path, w: np.ndarray, shape) -> np.ndarray:
    if len(shape) == 4 and path[-2] != "qkv":
        return w.transpose(2, 3, 1, 0)
    return w.T.reshape(shape)


def _collections(variables):
    if "params" in variables:
        return {k: v for k, v in variables.items()
                if k in ("params", "batch_stats")}
    return {"params": variables}


def from_jax(variables) -> Dict[str, torch.Tensor]:
    """A zoo model's flax variables (``{"params": ..., "batch_stats":
    ...}`` or a bare parameter tree, numpy leaves) -> the port's
    ``state_dict`` entries (see the module docstring's table)."""
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in _collections(variables).items():
        for path, leaf in _leaves(tree):
            a = np.asarray(leaf)
            if path[-1] == "kernel":
                a = _kernel_to_torch(path, a)
            elif path[-1] == "bias":
                a = a.reshape(-1)
            out[_torch_key(path, collection)] = torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.float32))
    return out


def to_jax(named: Dict[str, torch.Tensor], like) -> dict:
    """The port's tensors under ``state_dict`` keys (parameters, their
    gradients, running statistics) -> numpy arrays in the layout of
    ``like``, a flax variable or parameter tree with the same
    collections."""
    def convert(tree, collection, path=()):
        res = {}
        for key, value in tree.items():
            p = path + (key,)
            if isinstance(value, dict) or hasattr(value, "items"):
                res[key] = convert(value, collection, p)
                continue
            shape = np.shape(value)
            a = named[_torch_key(p, collection)].detach().float().cpu() \
                .numpy()
            if key == "kernel":
                a = _kernel_to_jax(p, a, shape)
            res[key] = np.ascontiguousarray(a.reshape(shape))
        return res

    if "params" in like:
        return {c: convert(t, c) for c, t in _collections(like).items()}
    return convert(like, "params")
