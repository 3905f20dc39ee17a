"""Reference PyTorch checkpoint -> flax-shaped parameter tree.

Port of ``molnextr_tpu/convert.py``.  The reference saves
``{'encoder': sd, 'decoder': sd, 'args': Namespace}`` with timm-Swin names
in the encoder and ONMT names in the decoders; this maps them onto the
tree that ``MolNexTRModel.init`` makes in the JAX package, which
``weights.load_flax_params`` then copies into the port's modules:

* torch Linear ``(out, in)`` -> Dense kernel ``(in, out)``,
* torch Conv2d ``(O, I, kh, kw)`` -> Conv kernel ``(kh, kw, I, O)``,
* per-layer decoder tensors stack into a leading ``L`` axis,
* LayerNorm weight/bias -> scale/bias.

The JAX converter also initialises the training-only ``heatmap_head``,
which the reference has no weights for; the port builds no such head, so
it is left out here.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from molnextr_tpu_torch.config import Config


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _strip_ddp(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Remove the 'module.' prefixes of a DistributedDataParallel save."""
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def _linear(sd, name) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{name}.weight"]).T}
    if f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def _layernorm(sd, name) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}


def convert_encoder(sd: Dict[str, Any], cfg: Config) -> Dict[str, Any]:
    """timm-Swin state dict (prefixed ``transformer.``) -> SwinEncoder tree."""
    sd = _strip_ddp(sd)
    p = "transformer."
    out: Dict[str, Any] = {}
    conv_w = _np(sd[p + "patch_embed.proj.weight"])  # (O, I, kh, kw)
    out["patch_embed"] = {
        "kernel": conv_w.transpose(2, 3, 1, 0),
        "bias": _np(sd[p + "patch_embed.proj.bias"]),
    }
    if p + "patch_embed.norm.weight" in sd:
        out["patch_norm"] = _layernorm(sd, p + "patch_embed.norm")
    for s, depth in enumerate(cfg.encoder.depths):
        for j in range(depth):
            bp = f"{p}layers.{s}.blocks.{j}."
            out[f"stage{s}_block{j}"] = {
                "norm1": _layernorm(sd, bp + "norm1"),
                "norm2": _layernorm(sd, bp + "norm2"),
                "attn": {
                    "qkv": _linear(sd, bp + "attn.qkv"),
                    "proj": _linear(sd, bp + "attn.proj"),
                    "rel_bias": _np(sd[bp + "attn.relative_position_bias_table"]),
                },
                "fc1": _linear(sd, bp + "mlp.fc1"),
                "fc2": _linear(sd, bp + "mlp.fc2"),
            }
        dp = f"{p}layers.{s}.downsample."
        if dp + "reduction.weight" in sd:
            out[f"merge{s}"] = {
                "norm": _layernorm(sd, dp + "norm"),
                "reduction": {"kernel": _np(sd[dp + "reduction.weight"]).T},
            }
    out["norm"] = _layernorm(sd, p + "norm")
    return out


def _stack_layers(per_layer: List[Dict[str, Any]]) -> Dict[str, Any]:
    """List of per-layer trees -> one tree with a stacked leading axis."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {key: _stack_layers([layer[key] for layer in per_layer]) for key in first}
    return np.stack(per_layer)


def convert_decoder_format(sd: Dict[str, Any], cfg: Config, fmt: str) -> Dict[str, Any]:
    """One reference TransformerDecoderAR -> Decoder tree."""
    sd = _strip_ddp(sd)
    p = f"decoder.{fmt}."
    layers: List[Dict[str, Any]] = []
    for i in range(cfg.decoder.num_layers):
        lp = f"{p}decoder.transformer_layers.{i}."
        layers.append(
            {
                "ln1": _layernorm(sd, lp + "layer_norm_1"),
                "ln2": _layernorm(sd, lp + "layer_norm_2"),
                "self_attn": {
                    "q": _linear(sd, lp + "self_attn.linear_query"),
                    "k": _linear(sd, lp + "self_attn.linear_keys"),
                    "v": _linear(sd, lp + "self_attn.linear_values"),
                    "out": _linear(sd, lp + "self_attn.final_linear"),
                },
                "cross_attn": {
                    "q": _linear(sd, lp + "context_attn.linear_query"),
                    "k": _linear(sd, lp + "context_attn.linear_keys"),
                    "v": _linear(sd, lp + "context_attn.linear_values"),
                    "out": _linear(sd, lp + "context_attn.final_linear"),
                },
                "ffn": {
                    "ln": _layernorm(sd, lp + "feed_forward.layer_norm"),
                    "w1": _linear(sd, lp + "feed_forward.w_1"),
                    "w2": _linear(sd, lp + "feed_forward.w_2"),
                },
            }
        )
    return {
        "embed": {"embedding": _np(sd[p + "embeddings.make_embedding.emb_luts.0.weight"])},
        "layers": _stack_layers(layers),
        "final_ln": _layernorm(sd, p + "decoder.layer_norm"),
        "output": _linear(sd, p + "output_layer"),
    }


def convert_checkpoint(torch_ckpt: Dict[str, Any], cfg: Config) -> Dict[str, Any]:
    """Full reference checkpoint (keys 'encoder' and 'decoder', each a state
    dict) -> ``{'params': tree}``."""
    enc_sd = _strip_ddp(torch_ckpt["encoder"])
    dec_sd = _strip_ddp(torch_ckpt["decoder"])
    params: Dict[str, Any] = {"encoder": convert_encoder(enc_sd, cfg)}
    # enc_trans lives inside each reference decoder; take the primary format's
    seq_fmts = [f for f in cfg.data.formats if f != "edges"]
    params["enc_trans"] = _linear(dec_sd, f"decoder.{seq_fmts[0]}.enc_trans_layer.0")
    for fmt in seq_fmts:
        params[f"decoders_{fmt}"] = convert_decoder_format(dec_sd, cfg, fmt)
    if "edges" in cfg.data.formats:
        # the reference's concat-input Linear (D, 2D) factors into row/col
        # halves: kernel rows [0:D] act on atom i, rows [D:2D] on atom j
        mlp1 = _linear(dec_sd, "decoder.edges.mlp.0")
        d_in = mlp1["kernel"].shape[0] // 2
        head = {
            "mlp1_row": {"kernel": mlp1["kernel"][:d_in], "bias": mlp1["bias"]},
            "mlp1_col": {"kernel": mlp1["kernel"][d_in:]},
            "mlp2": _linear(dec_sd, "decoder.edges.mlp.2"),
        }
        if "decoder.edges.coords_mlp.0.weight" in dec_sd:
            head["coords1"] = _linear(dec_sd, "decoder.edges.coords_mlp.0")
            head["coords2"] = _linear(dec_sd, "decoder.edges.coords_mlp.2")
        params["edges_head"] = head
    return {"params": params}


def load_torch_checkpoint(path: str, cfg: Optional[Config] = None):
    """Read a reference ``.pth`` and convert it -> (cfg, ``{'params': tree}``).

    The file is read with ``torch.load(weights_only=True)``, which admits
    tensors and plain containers, plus ``argparse.Namespace``, the type of
    the ``args`` the reference saves; a file holding any other global is
    refused with ``ValueError``.  The saved args ``formats``,
    ``input_size``, ``coord_bins`` and ``sep_xy`` are restored into
    ``cfg`` (``Config()`` when None), which is changed in place.
    """
    try:
        with torch.serialization.safe_globals([argparse.Namespace]):
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: refused; a reference checkpoint holds tensors, containers and an "
            f"argparse.Namespace only ({str(e).splitlines()[-1]})"
        ) from e
    cfg = cfg or Config()
    args = ckpt.get("args", {})
    if isinstance(args, argparse.Namespace):
        args = vars(args)
    if "formats" in args:
        f = args["formats"]
        cfg.data.formats = tuple(f.split(",") if isinstance(f, str) else f)
    if "input_size" in args:
        cfg.data.input_size = int(args["input_size"])
    if "coord_bins" in args:
        cfg.data.coord_bins = int(args["coord_bins"])
    if "sep_xy" in args:
        cfg.data.sep_xy = bool(args["sep_xy"])
    return cfg, convert_checkpoint(ckpt, cfg)
