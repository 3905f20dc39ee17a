"""Weight carry-over between the JAX package's parameter tree and the port.

* :func:`load_flax_params` copies a flax parameter tree (numpy leaves, as
  ``checkpoint.load_model`` returns it) into a port model.  The names map
  one to one, with three layout changes: the ``nn.scan``-stacked decoder
  layers (leading ``L`` axis) are unstacked into ``layers.<i>``; each
  attention's separate ``q``/``k``/``v`` Dense layers are concatenated into
  one ``(D, 3D)`` ``qkv`` Dense; the HWIO patch-embed kernel is flattened to
  ``(p*p*3, C)``; every other 4-D kernel (the ConvNeXt and DAHead
  convolutions) is transposed from flax's HWIO to PyTorch's OIHW.  Flax
  ``Dense`` kernels are ``(in, out)`` in both.  The
  training-only ``heatmap_head`` is carried when both sides have it; a
  serving bundle without it loads into a model that builds it.
* :func:`model_to_flax_params` is the reverse: a port model -> the JAX
  package's ``{"params": tree}`` of float32 numpy arrays, which
  ``checkpoint.save_model`` writes in the JAX package's format.
* :func:`seeded_flax_params` makes a numpy tree with the names and shapes
  of ``MolNexTRModel.init`` (Swin or ConvNeXt) from a numpy
  ``RandomState``, :func:`seeded_tree` one of any shapes (a DAHead's):
  normal * 0.02 for kernels, embeddings and
  ``rel_bias``, ones for LayerNorm scales, zeros for biases, and U(0.5,
  1.5) for the scales that flax initialises to (almost) zero, ConvNeXt's
  per-block ``gamma`` and DAHead's ``alpha`` and ``beta``: at their init
  values every ConvNeXt block and both attentions would be the identity,
  and a comparison of them would pass on any code.  Both frameworks can
  then run the same full-width model without JAX on the card.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from molnextr_tpu_torch.config import Config
from molnextr_tpu_torch.models.swin import effective_window

OPTIONAL = "heatmap_head"  # training-only: either side may lack it
N_HEATMAP_OUT = 13  # presence + 11 element classes + "other"
LAYER_SCALES = ("gamma", "alpha", "beta")  # drawn U(0.5, 1.5) by seeded_tree
PATCH_EMBED = ["encoder", "patch_embed", "kernel"]


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def flax_to_state_dict(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Flax parameter tree -> the port's state-dict names and layouts."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, np.ndarray] = {}
    qkv: Dict[Tuple[str, str, str], Dict[str, np.ndarray]] = {}
    for path, arr in _flatten(params).items():
        parts = path.split("/")
        if parts[0].startswith("decoders_"):
            parts = ["decoders", parts[0][len("decoders_"):]] + parts[1:]
        if parts[:3] == PATCH_EMBED:
            arr = arr.reshape(-1, arr.shape[-1])
        elif parts[-1] == "kernel" and arr.ndim == 4:  # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        if len(parts) > 3 and parts[0] == "decoders" and parts[2] == "layers":
            prefix, rest = ".".join(parts[:3]), parts[3:]
            if rest[0] in ("self_attn", "cross_attn") and rest[1] in ("q", "k", "v"):
                qkv.setdefault((prefix, rest[0], rest[2]), {})[rest[1]] = arr
                continue
            for i in range(arr.shape[0]):
                out[".".join([prefix, str(i)] + rest)] = arr[i]
            continue
        out[".".join(parts)] = arr
    for (prefix, attn, leaf), parts_qkv in qkv.items():
        cat = np.concatenate([parts_qkv["q"], parts_qkv["k"], parts_qkv["v"]], axis=-1)
        for i in range(cat.shape[0]):
            out[f"{prefix}.{i}.{attn}.qkv.{leaf}"] = cat[i]
    return out


def check_flax_params(model: torch.nn.Module, params: Dict[str, Any]) -> Dict[str, Any]:
    """The port state dict of a flax parameter tree, once every parameter of
    ``model`` is covered and every shape matches (raises otherwise), except
    the training-only ``heatmap_head``, which may be on one side only."""
    sd = flax_to_state_dict(params)
    own = dict(model.named_parameters())
    missing = sorted(n for n in set(own) - set(sd) if not n.startswith(OPTIONAL + "."))
    unexpected = sorted(n for n in set(sd) - set(own) if not n.startswith(OPTIONAL + "."))
    if missing or unexpected:
        raise KeyError(f"parameter mismatch: missing {missing[:8]}, unexpected {unexpected[:8]}")
    for name, p in own.items():
        if name in sd and tuple(sd[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {sd[name].shape} != {tuple(p.shape)}")
    return sd


def load_flax_params(model: torch.nn.Module, params: Dict[str, Any]) -> torch.nn.Module:
    """Copy a flax parameter tree into ``model`` in place, after
    :func:`check_flax_params` (a model's ``heatmap_head`` that the tree
    lacks keeps its values)."""
    sd = check_flax_params(model, params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in sd:
                p.copy_(torch.from_numpy(np.array(sd[name], dtype=np.float32)))
    return model


def model_to_flax_params(model: torch.nn.Module) -> Dict[str, Any]:
    """A port model -> ``{"params": tree}`` with the JAX package's names and
    layouts, float32 numpy leaves (the inverse of :func:`flax_to_state_dict`)."""
    sd = {n: p.detach().float().cpu().numpy() for n, p in model.named_parameters()}
    return state_dict_to_flax(sd)


def state_dict_to_flax(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The port's parameter names and layouts -> ``{"params": tree}`` in the
    JAX package's (for parameters, or for their gradients).  The Swin patch
    size is read off the patch-embed kernel ``(p*p*3, C)``."""
    flat: Dict[str, np.ndarray] = {}
    stacked: Dict[str, Dict[int, np.ndarray]] = {}
    for name, arr in sd.items():
        parts = name.split(".")
        if parts[0] == "decoders":
            parts = [f"decoders_{parts[1]}"] + parts[2:]
        if parts[:3] == PATCH_EMBED:
            p = int(round((arr.shape[0] // 3) ** 0.5))
            arr = arr.reshape(p, p, -1, arr.shape[-1])
        elif parts[-1] == "kernel" and arr.ndim == 4:  # OIHW -> HWIO
            arr = arr.transpose(2, 3, 1, 0)
        if parts[0].startswith("decoders_") and parts[1] == "layers":
            layer, rest = int(parts[2]), parts[3:]
            if rest[0] in ("self_attn", "cross_attn") and rest[1] == "qkv":
                for i, piece in enumerate(np.split(arr, 3, axis=-1)):
                    key = "/".join([parts[0], "layers", rest[0], "qkv"[i], rest[2]])
                    stacked.setdefault(key, {})[layer] = piece
                continue
            stacked.setdefault("/".join([parts[0], "layers"] + rest), {})[layer] = arr
            continue
        flat["/".join(parts)] = arr
    for key, layers in stacked.items():
        flat[key] = np.stack([layers[i] for i in range(len(layers))])
    return {"params": _unflatten(flat)}


def _shape_helpers(s: Dict[str, Tuple[int, ...]]):
    def dense(path, din, dout, bias=True):
        s[f"{path}/kernel"] = (din, dout)
        if bias:
            s[f"{path}/bias"] = (dout,)

    def ln(path, dim):
        s[f"{path}/scale"] = (dim,)
        s[f"{path}/bias"] = (dim,)

    def conv(path, k, cin, cout, bias=True):  # flax HWIO
        s[f"{path}/kernel"] = (k, k, cin, cout)
        if bias:
            s[f"{path}/bias"] = (cout,)

    return dense, ln, conv


def _convnext_shapes(e, s: Dict[str, Tuple[int, ...]]) -> list:
    """ConvNeXtEncoder's parameters into ``s``; returns the stage widths."""
    dense, ln, conv = _shape_helpers(s)
    dims = [int(d) for d in e.convnext_dims]
    conv("encoder/stem", 4, 3, dims[0])
    ln("encoder/stem_norm", dims[0])
    for stage, depth in enumerate(e.convnext_depths):
        dim = dims[stage]
        if stage > 0:
            ln(f"encoder/down_norm{stage}", dims[stage - 1])
            conv(f"encoder/down{stage}", 2, dims[stage - 1], dim)
        for i in range(depth):
            blk = f"encoder/s{stage}_b{i}"
            conv(f"{blk}/dwconv", 7, 1, dim)
            ln(f"{blk}/norm", dim)
            dense(f"{blk}/pw1", dim, 4 * dim)
            dense(f"{blk}/pw2", 4 * dim, dim)
            s[f"{blk}/gamma"] = (dim,)
    ln("encoder/final_norm", dims[-1])
    return dims


def _swin_shapes(cfg: Config, s: Dict[str, Tuple[int, ...]]) -> list:
    """SwinEncoder's parameters into ``s``; returns the stage widths."""
    dense, ln, _ = _shape_helpers(s)
    e = cfg.encoder
    p = e.patch_size
    s["encoder/patch_embed/kernel"] = (p, p, 3, e.embed_dim)
    s["encoder/patch_embed/bias"] = (e.embed_dim,)
    if e.patch_norm:
        ln("encoder/patch_norm", e.embed_dim)
    res = (cfg.data.input_size // p,) * 2
    dims = [int(e.embed_dim * 2 ** i) for i in range(len(e.depths))]
    for stage, depth in enumerate(e.depths):
        dim = dims[stage]
        ws, _ = effective_window(e.window_size, res, 0)
        for i in range(depth):
            blk = f"encoder/stage{stage}_block{i}"
            ln(f"{blk}/norm1", dim)
            dense(f"{blk}/attn/qkv", dim, 3 * dim)
            s[f"{blk}/attn/rel_bias"] = ((2 * ws - 1) ** 2, e.num_heads[stage])
            dense(f"{blk}/attn/proj", dim, dim)
            ln(f"{blk}/norm2", dim)
            dense(f"{blk}/fc1", dim, int(dim * e.mlp_ratio))
            dense(f"{blk}/fc2", int(dim * e.mlp_ratio), dim)
        if stage < len(e.depths) - 1:
            ln(f"encoder/merge{stage}/norm", 4 * dim)
            dense(f"encoder/merge{stage}/reduction", 4 * dim, 2 * dim, bias=False)
            res = (res[0] // 2, res[1] // 2)
    ln("encoder/norm", dims[-1])
    return dims


def param_shapes(cfg: Config, vocab_sizes: Dict[str, int]) -> Dict[str, Tuple[int, ...]]:
    """Flax path -> shape for every parameter ``MolNexTRModel.init`` makes."""
    e, dcfg = cfg.encoder, cfg.decoder
    s: Dict[str, Tuple[int, ...]] = {}
    if e.name.startswith("swin"):
        dims = _swin_shapes(cfg, s)
    elif e.name.startswith("convnext"):
        dims = _convnext_shapes(e, s)
    else:
        raise ValueError(f"unknown encoder {e.name}")
    dense, ln, _ = _shape_helpers(s)
    d = dcfg.hidden_size
    dense("enc_trans", e.num_features, d)
    if dcfg.enc_pos_emb:
        s["enc_pos/embedding"] = (144, e.num_features)
    L, f = dcfg.num_layers, d * dcfg.ffn_mult
    coord_fmt = False
    for fmt in cfg.data.formats:
        if fmt == "edges":
            continue
        coord_fmt |= fmt in ("atomtok_coords", "chartok_coords")
        dec = f"decoders_{fmt}"
        s[f"{dec}/embed/embedding"] = (vocab_sizes[fmt], d)
        for name in ("ln1", "ln2", "ffn/ln"):
            s[f"{dec}/layers/{name}/scale"] = (L, d)
            s[f"{dec}/layers/{name}/bias"] = (L, d)
        for attn in ("self_attn", "cross_attn"):
            for proj in ("q", "k", "v", "out"):
                s[f"{dec}/layers/{attn}/{proj}/kernel"] = (L, d, d)
                s[f"{dec}/layers/{attn}/{proj}/bias"] = (L, d)
        s[f"{dec}/layers/ffn/w1/kernel"] = (L, d, f)
        s[f"{dec}/layers/ffn/w1/bias"] = (L, f)
        s[f"{dec}/layers/ffn/w2/kernel"] = (L, f, d)
        s[f"{dec}/layers/ffn/w2/bias"] = (L, d)
        ln(f"{dec}/final_ln", d)
        dense(f"{dec}/output", d, vocab_sizes[fmt])
    if "edges" in cfg.data.formats and coord_fmt:
        dense("edges_head/mlp1_row", d, d)
        dense("edges_head/mlp1_col", d, d, bias=False)
        dense("edges_head/mlp2", d, 7)
        if cfg.data.continuous_coords:
            dense("edges_head/coords1", d, d)
            dense("edges_head/coords2", d, 2)
    if cfg.train.aux_heatmap_weight > 0:
        fine = dims[1] if len(dims) > 1 else dims[0]
        dense("heatmap_head/fine", fine, 128)
        dense("heatmap_head/coarse", dims[-1], 128)
        dense("heatmap_head/out", 128, N_HEATMAP_OUT)
    return s


def seeded_tree(shapes: Dict[str, Tuple[int, ...]], seed: int = 0) -> Dict[str, Any]:
    """``{"params": tree}`` of float32 numpy arrays of ``shapes``, drawn in
    sorted path order from ``np.random.RandomState(seed)`` (module doc)."""
    rng = np.random.RandomState(seed)
    flat = {}
    for path, shape in sorted(shapes.items()):
        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("kernel", "embedding", "rel_bias"):
            flat[path] = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        elif leaf == "scale":
            flat[path] = np.ones(shape, np.float32)
        elif leaf in LAYER_SCALES:
            flat[path] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            flat[path] = np.zeros(shape, np.float32)
    return {"params": _unflatten(flat)}


def seeded_flax_params(cfg: Config, vocab_sizes: Dict[str, int], seed: int = 0) -> Dict[str, Any]:
    """:func:`seeded_tree` of :func:`param_shapes`: the model's parameters."""
    return seeded_tree(param_shapes(cfg, vocab_sizes), seed)
