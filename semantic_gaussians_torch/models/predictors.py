"""2D open-vocabulary predictor protocol and providers.

Port of semantic_gaussians_tpu.models.predictors. Fusion and evaluation
consume per-pixel feature maps [H, W, C] and L2-normalized text features
[K, C] through one duck-typed protocol (`embedding_dim`,
`extract_image_feature(img, img_size=(W, H))`, `extract_text_feature`):

  * PrecomputedFeatureProvider: per-view feature maps exported by an
    offline 2D model (.npy / .npz / .pt), the production path for OpenSeg.
  * The model towers, on the device `make_predictor` is given:
    models.lseg.LSegPredictor (ViT-L/16 + DPT, 512-d), models.samclip.
    SAMCLIPPredictor (SAM automatic masks x CLIP crops, 768-d),
    models.vlpart.VLPartPredictor (detector + SAM box masks + CLIP text,
    768-d) and the text encoders models.clip_text.CLIPTextEncoder (OpenAI
    checkpoints) and TorchCLIPTextEncoder (a Hugging Face CLIP directory).
    Checkpoints are local files; none is shipped.
  * RandomFeatureProvider: deterministic random features keyed by path or
    label, identical to the JAX package's for the same keys.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch


def _resize_chw_nearest(feat_hwc: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize of an [H, W, C] map to (W, H)."""
    w, h = size
    src_h, src_w = feat_hwc.shape[:2]
    ys = (np.arange(h) * src_h // h).clip(0, src_h - 1)
    xs = (np.arange(w) * src_w // w).clip(0, src_w - 1)
    return feat_hwc[ys][:, xs]


class PrecomputedFeatureProvider:
    """Per-view feature maps exported by an offline 2D model.

    Files are looked up as <dir>/<image_stem>.{npy,npz,pt}; content is
    [H, W, C] or [C, H, W]. A map whose first axis equals `embedding_dim` is
    taken as CHW (the reference's export layout wins the ambiguous case).
    Maps come back as `dtype` (float32, as the JAX package returns them;
    float16 hands a half-precision export over as it is stored, with the
    same values and without two conversions of ~1 GB a view).
    """

    def __init__(self, feature_dir, embedding_dim: int = 768, dtype="float32"):
        self.feature_dir = Path(feature_dir)
        self.embedding_dim = embedding_dim
        self.dtype = np.dtype(dtype)

    def extract_image_feature(self, img_path, img_size):
        stem = Path(img_path).stem
        for ext in (".npy", ".npz", ".pt"):
            p = self.feature_dir / (stem + ext)
            if p.exists():
                break
        else:
            raise FileNotFoundError(f"no feature map for {stem} in {self.feature_dir}")
        if p.suffix == ".npy":
            feat = np.load(p)
        elif p.suffix == ".npz":
            data = np.load(p)
            feat = data[list(data.keys())[0]]
        else:
            obj = torch.load(p, map_location="cpu", weights_only=True)
            feat = obj["feat"] if isinstance(obj, dict) else obj
            feat = feat.numpy() if feat.dtype == torch.float16 else feat.float().numpy()
        if feat.ndim != 3:
            raise ValueError(f"bad feature map shape {feat.shape}")
        if feat.shape[0] == self.embedding_dim:
            feat = np.moveaxis(feat, 0, -1)  # CHW -> HWC
        if img_size is not None and (feat.shape[1], feat.shape[0]) != tuple(img_size):
            feat = _resize_chw_nearest(feat, img_size)
        return feat.astype(self.dtype, copy=False)

    def extract_text_feature(self, labelset):
        raise NotImplementedError(
            "precomputed provider has no text tower; pair with a CLIP text encoder"
        )


class RandomFeatureProvider:
    """Deterministic random features keyed by file path or label."""

    def __init__(self, embedding_dim: int = 16, feat_hw: Tuple[int, int] = (60, 80)):
        self.embedding_dim = embedding_dim
        self.feat_hw = feat_hw

    def _rng(self, key: str):
        seed = int.from_bytes(hashlib.sha256(key.encode()).digest()[:4], "little")
        return np.random.default_rng(seed)

    def extract_image_feature(self, img_path, img_size):
        h, w = self.feat_hw
        feat = self._rng(str(img_path)).normal(size=(h, w, self.embedding_dim))
        feat = feat.astype(np.float32)
        if img_size is not None:
            feat = _resize_chw_nearest(feat, img_size)
        return feat

    def extract_text_feature(self, labelset: Sequence[str]) -> np.ndarray:
        feats = np.stack(
            [self._rng("text:" + l).normal(size=self.embedding_dim) for l in labelset]
        ).astype(np.float32)
        return feats / np.linalg.norm(feats, axis=-1, keepdims=True)


_SAFETENSORS_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
                       "BF16": np.int16, "I64": np.int64, "I32": np.int32, "I16": np.int16,
                       "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path) -> dict:
    """{name: CPU tensor} of a .safetensors file: an 8-byte little-endian
    header length, a JSON header of {name: {dtype, shape, data_offsets}}
    and the raw little-endian tensors after it."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        begin, end = meta["data_offsets"]
        arr = np.frombuffer(data[begin:end], dtype=_SAFETENSORS_DTYPES[meta["dtype"]])
        t = torch.from_numpy(arr.copy()).reshape(meta["shape"])
        out[name] = t.view(torch.bfloat16) if meta["dtype"] == "BF16" else t
    return out


class TorchCLIPTextEncoder:
    """The CLIP text tower of a LOCAL Hugging Face CLIP directory (what
    `CLIPModel.save_pretrained` plus the tokenizer's `save_pretrained`
    write), read without `transformers`: `config.json`'s `text_config`,
    the weights from `model.safetensors` or `pytorch_model.bin`, the
    tokenizer from `vocab.json` + `merges.txt`. The text keys are mapped
    onto models.clip_text's tower. Encodes the raw label strings (no
    prompt template) and L2-normalizes, as the reference does. Runs on
    CUDA unless `device` asks for the CPU."""

    def __init__(self, model_path, embedding_dim: int = 768, device=None):
        from ..utils.device import resolve_device
        from .clip_text import CLIPTextEncoder, CLIPTextTower, SimpleTokenizer, hf_to_openai

        device = resolve_device(device)
        root = Path(model_path)
        cfg = json.loads((root / "config.json").read_text())
        text_cfg = cfg.get("text_config", cfg)
        if text_cfg.get("hidden_act", "quick_gelu") != "quick_gelu" or \
                float(text_cfg.get("layer_norm_eps", 1e-5)) != 1e-5:
            raise ValueError("only OpenAI CLIP text towers (quick_gelu, LayerNorm eps 1e-5)")
        if (root / "model.safetensors").exists():
            sd = read_safetensors(root / "model.safetensors")
        else:
            sd = torch.load(root / "pytorch_model.bin", map_location="cpu", weights_only=True)
        sd = hf_to_openai({k: v.float() for k, v in sd.items()})
        vocab, width = sd["token_embedding.weight"].shape
        tower = CLIPTextTower(vocab_size=vocab, context_length=sd["positional_embedding"].shape[0],
                              width=width, layers=int(text_cfg["num_hidden_layers"]),
                              heads=int(text_cfg["num_attention_heads"]),
                              embed_dim=sd["text_projection"].shape[1])
        tower.load_state_dict(sd)
        encoder = json.loads((root / "vocab.json").read_text(encoding="utf-8"))
        lines = (root / "merges.txt").read_text(encoding="utf-8").split("\n")
        merges = [tuple(m.split()) for m in lines if m and not m.startswith("#version")]
        self.encoder = CLIPTextEncoder(
            tower=tower, tokenizer=SimpleTokenizer(encoder=encoder, merges=merges),
            sot=encoder["<|startoftext|>"], eot=encoder["<|endoftext|>"], device=device)
        self.embedding_dim = self.encoder.embedding_dim
        if self.embedding_dim != embedding_dim:
            raise ValueError(f"{model_path}: text features are {self.embedding_dim}-d, "
                             f"expected {embedding_dim}")

    def extract_text_feature(self, labelset):
        return self.encoder.extract_text_feature(list(labelset))

    def extract_image_feature(self, img_path, img_size):
        raise NotImplementedError("text-only encoder")


def make_predictor(name: str, cfg, device=None):
    """Build a 2D provider by name from the `fusion` (or `eval`) config
    section: precomputed / openseg (offline exports), lseg, samclip,
    vlpart (local checkpoints: `lseg_checkpoint`, `sam_checkpoint`,
    `clip_checkpoint`, `bpe_path`, `detections_dir`, `vocabulary`) and
    random. The towers run on `device` (CUDA unless the CPU is asked for)."""
    get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: d
    if name in ("precomputed", "openseg"):
        return PrecomputedFeatureProvider(
            cfg["feature_dir"], int(get("embedding_dim", 768)), get("feat_dtype") or "float32"
        )
    if name == "random":
        return RandomFeatureProvider(int(get("embedding_dim", 768)))
    if name not in ("lseg", "samclip", "vlpart"):
        raise ValueError(f"unknown model_2d: {name}")
    from ..utils.device import resolve_device

    device = resolve_device(device)
    bpe = get("bpe_path")  # CLIP BPE merges file for string text queries
    if name == "lseg":
        from .lseg import LSegPredictor

        return LSegPredictor(checkpoint_path=cfg["lseg_checkpoint"], bpe_path=bpe, device=device)
    from .clip_text import CLIPTextEncoder
    from .common import load_torch_state_dict
    from .sam import Sam

    clip_sd = load_torch_state_dict(cfg["clip_checkpoint"])
    text_encoder = CLIPTextEncoder(state_dict=clip_sd, bpe_path=bpe, device=device)
    # the config the weights describe (vit_h for sam_vit_h_4b8939.pth; the
    # JAX package takes vit_h whatever the file holds)
    sam = Sam.from_state_dict(load_torch_state_dict(cfg["sam_checkpoint"]))
    if name == "samclip":
        from .clip_vision import CLIPImageEncoder
        from .samclip import SAMCLIPPredictor

        return SAMCLIPPredictor(sam_model=sam, text_encoder=text_encoder, device=device,
                                clip_encoder=CLIPImageEncoder(state_dict=clip_sd, device=device))
    from .vlpart import NativeOpenVocabDetector, PrecomputedDetections, VLPartPredictor

    if get("detections_dir"):
        # offline exports of the upstream detector (tools/export_vlpart_detections.py)
        detector = PrecomputedDetections(cfg["detections_dir"])
    else:
        # SAM proposals x CLIP classification, sharing SAM with the box stage
        from .automask import SamAutoMask
        from .clip_vision import CLIPImageEncoder

        detector = NativeOpenVocabDetector(
            SamAutoMask(sam.to(device)), CLIPImageEncoder(state_dict=clip_sd, device=device),
            text_encoder)
    return VLPartPredictor(detector, sam_model=sam, text_encoder=text_encoder, device=device,
                           vocabulary=list(get("vocabulary") or []) or None)


def load_image(img) -> np.ndarray:
    """A path or an array -> RGB uint8 (float arrays in [0, 1] or [0, 255]
    are scaled and clipped)."""
    if not isinstance(img, np.ndarray):
        from PIL import Image

        return np.asarray(Image.open(str(img)).convert("RGB"))
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.0 else arr, 0, 255).astype(np.uint8)
    return arr
