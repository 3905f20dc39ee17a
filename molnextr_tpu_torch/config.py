"""Typed configuration, copied from ``molnextr_tpu/config.py``.

The PyTorch port keeps its own copy so that it imports nothing of the JAX
package; the dataclasses, defaults and JSON layout are identical, so a
``config.json`` written by either package loads in the other.  The defaults
are the JAX package's; a time in a comment was measured with this port on
an H100, by the script it names.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class EncoderConfig:
    """Image encoder configuration.

    `name` selects the backbone family the same way the reference's
    ``--encoder`` flag does (`components.py:110-134`): ``swin_*`` builds the
    windowed vision transformer, ``convnext*`` the ConvNeXt CNN.
    """

    name: str = "swin_base"
    # Swin-base: patch 4, window 12, dim 128, depths (2,2,18,2), heads
    # (4,8,16,32) at 384x384 (`models/transformers.py:547-551`).
    patch_size: int = 4
    window_size: int = 12
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.1
    ape: bool = False  # absolute position embedding
    patch_norm: bool = True
    use_remat: bool = True  # jax.checkpoint per block (ref: --use_checkpoint)
    softmax_f32: bool = True  # f32 window-attention softmax (False halves traffic)
    # ConvNeXt alternative backbone
    convnext_depths: Tuple[int, ...] = (3, 3, 27, 3)
    convnext_dims: Tuple[int, ...] = (128, 256, 512, 1024)

    @property
    def num_features(self) -> int:
        if self.name.startswith("swin"):
            return int(self.embed_dim * 2 ** (len(self.depths) - 1))
        return int(self.convnext_dims[-1])


@dataclass
class DecoderConfig:
    """Autoregressive decoder + graph head configuration.

    Matches the reference transformer options (`main.py:57-64`,
    `model.py:62-68`): 6 layers x 256 dim x 8 heads, GELU FFN of 4x width,
    pre-norm layers with a final LayerNorm.
    """

    num_layers: int = 6
    hidden_size: int = 256
    attn_heads: int = 8
    ffn_mult: int = 4
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    enc_pos_emb: bool = False  # optional 144-slot encoder pos emb (`components.py:187`)
    max_len: int = 480  # FORMAT_INFO cap (`utils.py:24-25`)
    use_remat: bool = True  # rematerialize decoder layers in training
    # the teacher-forced self-attention through the causal flash kernels
    # (ops/flash_attention.py: K7 forward, K8 and K9 backward), as the JAX
    # package's flag sends it through JAX's library flash kernel.  Taken
    # where the JAX package takes it: attention dropout inactive, T a
    # multiple of 128, MOLNEXTR_NO_FLASH unset, and the tensors on the card.
    # The route drops the padding mask (causal only), which changes PAD
    # query rows only, whose loss is ignored.  Off by default.
    use_flash_attention: bool = False
    # int8 KV caches for the decode loop (inference only; training's
    # teacher-forced pass never builds a cache).  K/V are quantized per
    # token (max-abs over the head/channel axis, symmetric, scale folded
    # into the products: exact up to the 8-bit rounding); the scales ride
    # the cache dict as extra "<name>_scale" entries, so beam's reorder
    # handles them generically.  On by default, as in the JAX package,
    # whose trained-checkpoint A/B (AB_INT8_r5.json, n=256) found equal
    # suite-level accuracy; the port's own A/B on the demo bundle agrees
    # 0.9727 with the dense cache (PERF.md).  It does not make the port
    # faster: bench_torch.py at batch 256 (bf16, 480 forced steps; median
    # of 3 processes each, in turns, NVIDIA H100 80GB HBM3, 700.00 W) gave
    # 59.19 img/s with it and 79.28 with --no-kv-int8.  The decode step is
    # host-bound; that the int8 step's extra small ops (the new K/V
    # quantized per layer, scales written and read) make the difference is
    # a guess no count or profile has checked yet.
    kv_int8: bool = True


@dataclass
class DataConfig:
    input_size: int = 384
    coord_bins: int = 64
    sep_xy: bool = True
    continuous_coords: bool = False
    formats: Tuple[str, ...] = ("chartok_coords", "edges")
    vocab_file: Optional[str] = None
    mask_ratio: float = 0.0
    mol_augment: bool = True
    include_condensed: bool = True
    shuffle_nodes: bool = False
    pseudo_coords: bool = False
    augment: bool = True
    rotate: bool = True
    # also train on the structured clutter-noise family the perturbed
    # robustness suite uses (line/bond/symbol noise, borders) — off for the
    # clean phases, on for the augmentation fine-tune (scripts/
    # train_druglike.py --image-augment-only)
    clutter_augment: bool = False
    max_atoms: int = 128  # static pad for edge matrices / atom indices
    # eval-dataset name ("acs"/"uob"/a test_file path): selects the
    # per-dataset transform composition (`dataset.py:165-167`)
    dataset_name: Optional[str] = None
    # cache base synthetic renders across epochs (per-sample molecular
    # augmentation frozen; image augmentations still vary) — rendering is
    # the dominant host cost on low-core hosts
    render_cache: bool = False
    # render TRAIN images with the deterministic default style (the one
    # eval uses) instead of per-sample style jitter — pipeline sanity /
    # overfit probes need train and eval renders to be pixel-identical
    default_style: bool = False


@dataclass
class TrainConfig:
    seed: int = 42
    epochs: int = 40
    batch_size: int = 256  # global batch across the mesh
    encoder_lr: float = 4e-4
    decoder_lr: float = 4e-4
    weight_decay: float = 1e-6
    max_grad_norm: float = 5.0
    scheduler: str = "cosine"  # or "constant"
    warmup_ratio: float = 0.02
    label_smoothing: float = 0.1
    grad_accum_steps: int = 1
    # optimizer updates per dispatch unit: the JAX package scans this many
    # batches in one jitted call; the port's train loop groups the batches
    # so (train/loop.py, dispatch_units) and steps through each group one
    # batch at a time, averaging the group's metrics.  1 = one step per
    # unit (the reference's structure, `main.py:204-255`).
    dispatch_steps: int = 1
    save_mode: str = "best"  # best | all | last
    save_path: str = "output/"
    num_workers: int = 8
    train_steps_per_epoch: int = -1
    bf16: bool = True
    mesh_shape: Tuple[int, ...] = (-1,)  # -1 => all devices on the data axis
    mesh_axes: Tuple[str, ...] = ("data",)
    # Auxiliary dense supervision on the encoder: a per-cell atom
    # presence + element-class head over the stride-8 feature map.  The
    # reference trains from an ImageNet-pretrained Swin; from scratch the
    # decoder's teacher-forced LM shortcut starves the encoder of gradient
    # and its output collapses to a constant (measured: memory spatial std
    # 0.002 vs 0.11 overall after 400 overfit steps, predictions identical
    # for a blank image).  Dense heatmap gradients make collapse impossible.
    # weight 0.0 disables the head (and removes its params from the tree).
    aux_heatmap_weight: float = 1.0
    aux_heatmap_stride: int = 8


@dataclass
class DecodeConfig:
    beam_size: int = 1
    n_best: int = 1
    min_length: int = 1
    batch_size: int = 32
    compute_confidence: bool = False
    keep_main_molecule: bool = False
    molblock: bool = False
    # decode steps between the host's finished.all() checks, the decode
    # loops' only host sync (decoding/greedy.py, decoding/beam.py; in the
    # JAX package, steps per lax.while_loop iteration).  Finished rows
    # write PAD, so every value gives the same tokens.  Swept with
    # scripts/bench_decode_torch.py at batch 256 (bf16, best of 3 unforced
    # decodes of distinct inputs each, two runs, NVIDIA H100 80GB HBM3,
    # 700.00 W), in ms a step as (best - encode) / 480, as the JAX
    # package's scripts/bench_decode.py counts it, and in brackets over
    # the 442 (unroll 1, 2) or 444 (4) steps the decodes ran: 1 -> 7.409 /
    # 8.635 [8.046 / 9.377], 2 -> 8.796 / 8.443 [9.553 / 9.168], 4 ->
    # 7.215 / 7.120 [7.800 / 7.697].  4 was the best in both; over all
    # sweeps of this script 2 and 4 took turns as the best (PERF.md),
    # within the runs' spread.  4 is the JAX package's default.
    unroll: int = 4
    # "roundtrip" re-renders each candidate (graph view, token view, beam
    # n-best) with the in-repo renderer and keeps the best ink-IoU match
    # against the input image (see rerank.py — measured oracle headroom
    # +6pt at beam 4).  Host-side, opt-in, off by default.
    rerank: Optional[str] = None


@dataclass
class Config:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        def build(tp, sub):
            fields = {f.name: f for f in dataclasses.fields(tp)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    continue
                ft = fields[k].type
                if isinstance(v, list) and "Tuple" in str(ft):
                    v = tuple(v)
                kwargs[k] = v
            return tp(**kwargs)

        return cls(
            encoder=build(EncoderConfig, d.get("encoder", {})),
            decoder=build(DecoderConfig, d.get("decoder", {})),
            data=build(DataConfig, d.get("data", {})),
            train=build(TrainConfig, d.get("train", {})),
            decode=build(DecodeConfig, d.get("decode", {})),
        )

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))


def tiny_test_config() -> Config:
    """A miniature config for fast unit tests and the multichip dry-run."""
    cfg = Config()
    cfg.encoder = EncoderConfig(
        name="swin_tiny_test",
        patch_size=4,
        window_size=4,
        embed_dim=16,
        depths=(1, 1),
        num_heads=(2, 2),
        use_remat=False,
    )
    cfg.decoder = DecoderConfig(num_layers=2, hidden_size=32, attn_heads=2, max_len=24)
    cfg.data = DataConfig(input_size=32, coord_bins=8, max_atoms=8)
    cfg.train = TrainConfig(batch_size=8, bf16=False)
    return cfg
