"""Segment Anything (SAM): image encoder, prompt encoder and mask decoder.

Port of semantic_gaussians_tpu.models.sam, which SAMCLIP's automatic masks
and VLPart's box refinement run on:

  * ImageEncoderViT (ViT-det): patch conv, absolute position embedding on
    the token grid, blocks with windowed attention (global in
    `global_blocks`) and decomposed relative position bias, and a conv
    neck (1x1, LayerNorm2d, 3x3, LayerNorm2d) to the 256-d embedding.
  * PromptEncoder: random-Fourier position encoding of points and box
    corners plus learned per-type embeddings; the "no mask" dense
    embedding.
  * MaskDecoder: IoU + mask tokens before the prompt tokens, a two-layer
    two-way transformer, the final token-to-image attention, 4x
    transposed-conv upscaling, per-token hypernetwork MLPs and the IoU head.

`state_dict()` keys are those of the public `sam_vit_*.pth` checkpoints.
A public checkpoint also carries `prompt_encoder.mask_downscaling.*` (the
mask-prompt convs: this package prompts with points and boxes only, as the
JAX package does); `Sam.from_state_dict` leaves those out and loads the rest.

Kept from the JAX module where it differs from upstream SAM: every
LayerNorm (the encoder's blocks and LayerNorm2d, the decoder's norm1-4,
norm_final_attn and the upscaling LayerNorm2d) uses epsilon 1e-6, flax's
default (sam.py:359-373, 413); upstream's decoder LayerNorms use 1e-5.
GELU is erf-exact; the decoder MLPs use ReLU. Tensors are channel-last
(B, H, W, C) as in the JAX module.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .clip_text import count_blocks
from .common import float32_state, resize_bilinear

PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)
LN_EPS = 1e-6  # the JAX module's, every LayerNorm (upstream's decoder: 1e-5)


@dataclasses.dataclass(frozen=True)
class SamConfig:
    img_size: int = 1024
    patch: int = 16
    embed_dim: int = 1280  # vit_h
    depth: int = 32
    num_heads: int = 16
    window: int = 14
    global_blocks: Tuple[int, ...] = (7, 15, 23, 31)
    out_chans: int = 256
    decoder_dim: int = 256
    decoder_heads: int = 8
    decoder_mlp: int = 2048
    num_multimask: int = 3

    @staticmethod
    def vit_h() -> "SamConfig":
        return SamConfig()

    @staticmethod
    def vit_l() -> "SamConfig":
        return SamConfig(embed_dim=1024, depth=24, num_heads=16, global_blocks=(5, 11, 17, 23))

    @staticmethod
    def vit_b() -> "SamConfig":
        return SamConfig(embed_dim=768, depth=12, num_heads=12, global_blocks=(2, 5, 8, 11))

    @staticmethod
    def tiny(img_size: int = 64) -> "SamConfig":
        """Small config for tests: same topology, toy widths."""
        return SamConfig(img_size=img_size, patch=8, embed_dim=32, depth=2, num_heads=2,
                         window=2, global_blocks=(1,), out_chans=16, decoder_dim=16,
                         decoder_heads=2, decoder_mlp=32)

    @property
    def grid(self) -> int:
        return self.img_size // self.patch

    @staticmethod
    def from_state_dict(sd, decoder_heads: int = 8) -> "SamConfig":
        """The config a public-layout state dict describes: widths, depth,
        heads (width over the relative tables' head width), window and
        global blocks (by each block's table length). The decoder's head
        count is not in the weights: upstream's 8 unless given."""
        e = "image_encoder."
        embed_dim, _, patch, _ = sd[e + "patch_embed.proj.weight"].shape
        grid = sd[e + "pos_embed"].shape[1]
        depth = count_blocks(sd, e + "blocks.")
        lengths = [sd[f"{e}blocks.{i}.attn.rel_pos_h"].shape[0] for i in range(depth)]
        windowed = [n for n in lengths if n != 2 * grid - 1]
        return SamConfig(
            img_size=grid * patch, patch=patch, embed_dim=embed_dim, depth=depth,
            num_heads=embed_dim // sd[e + "blocks.0.attn.rel_pos_h"].shape[1],
            window=(windowed[0] + 1) // 2 if windowed else 14,
            global_blocks=tuple(i for i, n in enumerate(lengths) if n == 2 * grid - 1),
            out_chans=sd[e + "neck.0.weight"].shape[0],
            decoder_dim=sd["mask_decoder.iou_token.weight"].shape[1],
            decoder_heads=decoder_heads,
            decoder_mlp=sd["mask_decoder.transformer.layers.0.mlp.lin1.weight"].shape[0],
            num_multimask=sd["mask_decoder.mask_tokens.weight"].shape[0] - 1)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel (last) axis of a (B, H, W, C) map."""

    def __init__(self, c: int, eps: float = LN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + self.eps) * self.weight + self.bias


def window_partition(x, w: int):
    """(B, H, W, C) -> (B * nW, w, w, C), zero-padded; returns the padded
    (H, W) too."""
    b, h, wd, c = x.shape
    ph, pw = (-h) % w, (-wd) % w
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, wd + pw
    x = x.reshape(b, hp // w, w, wp // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w, w, c), (hp, wp)


def window_unpartition(x, w: int, pad_hw, hw):
    hp, wp = pad_hw
    h, wd = hw
    b = x.shape[0] // (hp // w * (wp // w))
    x = x.reshape(b, hp // w, wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :wd]


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(q_size, k_size, C) rows of the relative position table: entry
    [i, j] is table[i - j + k_size - 1] (scaled for unequal sizes). A table
    of another length than 2 * max(q, k) - 1 is first resized linearly as
    `jax.image.resize` resizes it (antialiased when it shrinks)."""
    max_rel = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel:
        # resized as a (C, L, 2) image: torch's antialiased path mishandles
        # an axis of length 1
        cols = rel_pos.T[None, :, :, None].expand(-1, -1, -1, 2)
        rel_pos = resize_bilinear(cols, (max_rel, 2))[0, :, :, 0].T
    dev = rel_pos.device
    qi = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    kj = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    idx = (qi - kj + (k_size - 1) * max(q_size / k_size, 1.0)).to(torch.long)
    return rel_pos[idx]


class VitDetAttention(nn.Module):
    """Multi-head attention over a (B, H, W, C) token grid with decomposed
    relative position bias (tables for a `size` x `size` grid)."""

    def __init__(self, dim: int, heads: int, size: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        hd = dim // heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, hd))

    def forward(self, x):
        b, h, w, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).reshape(b, h * w, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, heads, N, hd)
        attn = (q * hd ** -0.5) @ k.transpose(-1, -2)
        rh = get_rel_pos(h, h, self.rel_pos_h)
        rw = get_rel_pos(w, w, self.rel_pos_w)
        qg = q.reshape(b, self.heads, h, w, hd)
        bias_h = torch.einsum("bnhwc,hkc->bnhwk", qg, rh)
        bias_w = torch.einsum("bnhwc,wkc->bnhwk", qg, rw)
        attn = attn.reshape(b, self.heads, h, w, h, w)
        attn = attn + bias_h[..., :, None] + bias_w[..., None, :]
        attn = attn.reshape(b, self.heads, h * w, h * w).softmax(dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, h, w, c)
        return self.proj(out)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)


class VitDetBlock(nn.Module):
    def __init__(self, cfg: SamConfig, window: int):
        super().__init__()
        self.window = window  # 0 = global
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)
        self.attn = VitDetAttention(cfg.embed_dim, cfg.num_heads, window or cfg.grid)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)
        self.mlp = _Mlp(cfg.embed_dim, 4 * cfg.embed_dim)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window > 0:
            hw = x.shape[1:3]
            x, pad_hw = window_partition(x, self.window)
        x = self.attn(x)
        if self.window > 0:
            x = window_unpartition(x, self.window, pad_hw, hw)
        x = shortcut + x
        y = self.mlp.lin2(F.gelu(self.mlp.lin1(self.norm2(x))))
        return x + y


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch, stride=cfg.patch)


class _Conv1x1NHWC(nn.Conv2d):
    """A Conv2d applied to a (B, H, W, C) map."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.patch_embed = _PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.grid, cfg.grid, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            VitDetBlock(cfg, 0 if i in cfg.global_blocks else cfg.window)
            for i in range(cfg.depth))
        self.neck = nn.Sequential(
            _Conv1x1NHWC(cfg.embed_dim, cfg.out_chans, 1, bias=False),
            LayerNorm2d(cfg.out_chans),
            _Conv1x1NHWC(cfg.out_chans, cfg.out_chans, 3, padding=1, bias=False),
            LayerNorm2d(cfg.out_chans),
        )

    def forward(self, x):  # (B, S, S, 3) normalized -> (B, g, g, out_chans)
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x)


class _PositionEmbeddingRandom(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, d // 2))


class PromptEncoder(nn.Module):
    """Point / box prompts -> sparse embeddings; the "no mask" dense one."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.decoder_dim
        self.pe_layer = _PositionEmbeddingRandom(d)
        # 0: negative point, 1: positive point, 2 / 3: box corners
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)

    def pe_encode(self, coords01):
        """Random-Fourier position encoding of [0, 1] coords (..., 2)."""
        z = 2.0 * math.pi * ((2.0 * coords01 - 1.0) @ self.pe_layer.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(z), torch.cos(z)], dim=-1)

    def dense_pe(self):
        g = self.cfg.grid
        dev = self.no_mask_embed.weight.device
        c = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
        ys, xs = torch.meshgrid(c, c, indexing="ij")
        return self.pe_encode(torch.stack([xs, ys], dim=-1))  # (g, g, D)

    def _dense(self, b):
        g, d = self.cfg.grid, self.cfg.decoder_dim
        return self.no_mask_embed.weight[0].expand(b, g, g, d)

    def embed_boxes(self, boxes):
        """boxes (B, 4) xyxy in the encoder's input frame -> sparse (B, 2, D)
        corner embeddings and the dense embedding."""
        coords = (boxes.reshape(-1, 2, 2) + 0.5) / self.cfg.img_size
        corner = torch.stack([self.point_embeddings[2].weight[0],
                              self.point_embeddings[3].weight[0]])
        return self.pe_encode(coords) + corner, self._dense(boxes.shape[0])

    def forward(self, points, labels):
        """points (B, P, 2) pixels in the encoder's input frame; labels
        (B, P) in {-1 pad, 0 negative, 1 positive}."""
        pe = self.pe_encode((points + 0.5) / self.cfg.img_size)
        pad = (labels == -1)[..., None]
        pe = torch.where(pad, torch.zeros((), device=pe.device), pe)
        emb = torch.where(pad, self.not_a_point_embed.weight[0],
                          torch.where((labels == 1)[..., None], self.point_embeddings[1].weight[0],
                                      self.point_embeddings[0].weight[0]))
        return pe + emb, self._dense(points.shape[0])


class DownAttention(nn.Module):
    """Attention with the channels downsampled inside by `down`."""

    def __init__(self, dim: int, heads: int, down: int = 1):
        super().__init__()
        d = dim // down
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj = (nn.Linear(dim, d) for _ in range(3))
        self.out_proj = nn.Linear(d, dim)

    def forward(self, q, k, v):
        qp, kp, vp = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        d = qp.shape[-1]
        hd = d // self.heads

        def split(x):
            return x.reshape(x.shape[0], x.shape[1], self.heads, hd).transpose(1, 2)

        qh, kh, vh = split(qp), split(kp), split(vp)
        attn = ((qh / math.sqrt(hd)) @ kh.transpose(-1, -2)).softmax(dim=-1)
        out = (attn @ vh).transpose(1, 2).reshape(q.shape[0], q.shape[1], d)
        return self.out_proj(out)


class TwoWayBlock(nn.Module):
    def __init__(self, cfg: SamConfig, skip_first_pe: bool):
        super().__init__()
        d, h = cfg.decoder_dim, cfg.decoder_heads
        self.skip_first_pe = skip_first_pe
        self.self_attn = DownAttention(d, h)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.cross_attn_token_to_image = DownAttention(d, h, down=2)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp = _Mlp(d, cfg.decoder_mlp)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm4 = nn.LayerNorm(d, eps=LN_EPS)
        self.cross_attn_image_to_token = DownAttention(d, h, down=2)

    def forward(self, queries, keys, qpe, kpe):
        if self.skip_first_pe:  # the first layer's output replaces the queries
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + qpe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + qpe, keys + kpe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp.lin2(F.relu(self.mlp.lin1(queries))))
        q, k = queries + qpe, keys + kpe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class _TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        d = cfg.decoder_dim
        self.layers = nn.ModuleList([TwoWayBlock(cfg, True), TwoWayBlock(cfg, False)])
        self.final_attn_token_to_image = DownAttention(d, cfg.decoder_heads, down=2)
        self.norm_final_attn = nn.LayerNorm(d, eps=LN_EPS)


class _MLP3(nn.Module):
    def __init__(self, d: int, out: int):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, out)])

    def forward(self, x):
        for j, lin in enumerate(self.layers):
            x = lin(x)
            if j < 2:
                x = F.relu(x)
        return x


class _ConvT2NHWC(nn.ConvTranspose2d):
    """A 2x2 stride-2 transposed conv applied to a (B, H, W, C) map."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 2, stride=2)

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.decoder_dim
        self.transformer = _TwoWayTransformer(cfg)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(1 + cfg.num_multimask, d)
        self.output_upscaling = nn.Sequential(
            _ConvT2NHWC(d, d // 4), LayerNorm2d(d // 4), nn.GELU(), _ConvT2NHWC(d // 4, d // 8),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            _MLP3(d, d // 8) for _ in range(1 + cfg.num_multimask))
        self.iou_prediction_head = _MLP3(d, 1 + cfg.num_multimask)

    def forward(self, image_emb, image_pe, sparse_prompt, dense_prompt):
        """image_emb / image_pe (g, g, D); sparse (B, P, D); dense
        (B, g, g, D). Returns mask logits (B, 4, 4g, 4g) and IoU (B, 4)."""
        c = self.cfg
        b, g, d = sparse_prompt.shape[0], image_emb.shape[0], c.decoder_dim
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([tokens.expand(b, -1, -1), sparse_prompt], dim=1)
        src = (image_emb[None] + dense_prompt).reshape(b, g * g, d)
        pe = image_pe.reshape(1, g * g, d).expand(b, -1, -1)
        t = self.transformer
        q, k = t.layers[0](tokens, src, tokens, pe)
        q, k = t.layers[1](q, k, tokens, pe)
        attn = t.final_attn_token_to_image(q + tokens, k + pe, k)
        q = t.norm_final_attn(q + attn)
        # upscale the transformer-updated image embedding
        up = self.output_upscaling(k.reshape(b, g, g, d))  # (B, 4g, 4g, D/8)
        hyper = torch.stack([mlp(q[:, 1 + i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bkc,bhwc->bkhw", hyper, up)
        return masks, self.iou_prediction_head(q[:, 0])


class Sam(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    @classmethod
    def from_state_dict(cls, sd, cfg: SamConfig | None = None) -> "Sam":
        """The model (`cfg`, else the one the weights describe) with a
        public-layout state dict's weights in float32; the mask-prompt convs
        (`prompt_encoder.mask_downscaling.*`) are left out."""
        with torch.device("meta"):  # no init of weights about to be replaced
            model = cls(cfg or SamConfig.from_state_dict(sd))
        model.load_state_dict(float32_state(
            {k: v for k, v in sd.items() if not k.startswith("prompt_encoder.mask_downscaling.")}),
            assign=True)
        return model

    def encode_image(self, x):
        return self.image_encoder(x)

    def predict_points(self, image_emb, points, labels):
        """image_emb (g, g, D); points (B, P, 2) encoder-frame pixels;
        labels (B, P). A (0, 0) / -1 padding point is appended (upstream's
        box-less prompts). Returns mask logits (B, 4, 4g, 4g), IoU (B, 4)."""
        b = points.shape[0]
        points = torch.cat([points, points.new_zeros((b, 1, 2))], dim=1)
        labels = torch.cat([labels, -labels.new_ones((b, 1))], dim=1)
        sparse, dense = self.prompt_encoder(points, labels)
        return self.mask_decoder(image_emb, self.prompt_encoder.dense_pe(), sparse, dense)

    def predict_boxes(self, image_emb, boxes):
        """Box prompts, single-mask output (token 0). boxes (B, 4)
        encoder-frame xyxy. Returns logits (B, 4g, 4g), IoU (B,)."""
        sparse, dense = self.prompt_encoder.embed_boxes(boxes)
        masks, iou = self.mask_decoder(image_emb, self.prompt_encoder.dense_pe(), sparse, dense)
        return masks[:, 0], iou[:, 0]

    def forward(self, x, points, labels):
        return self.predict_points(self.encode_image(x)[0], points, labels)


def init_scales() -> dict:
    """Per-name init scales for `common.random_init_` that keep a random SAM
    close to its JAX init (flax normal(1.0) for the prompt tables and
    tokens), so that point prompts carry their position."""
    return {"positional_encoding_gaussian_matrix": 1.0, "point_embeddings.0.weight": 1.0,
            "point_embeddings.1.weight": 1.0, "point_embeddings.2.weight": 1.0,
            "point_embeddings.3.weight": 1.0, "not_a_point_embed.weight": 1.0,
            "no_mask_embed.weight": 1.0, "iou_token.weight": 1.0, "mask_tokens.weight": 1.0}


def state_from_flax(variables) -> dict:
    """The JAX Sam's variables -> this model's (public-layout) state dict.
    flax's transposed convs hold their kernels spatially flipped against
    torch's (sam.py:603-615), so the flip is undone here."""
    from .common import tensor_tree

    p = tensor_tree(variables["params"] if "params" in variables else variables)
    enc, pe, dec = p["image_encoder"], p["prompt_encoder"], p["mask_decoder"]
    sd = {}

    def dense(name, d):
        sd[name + ".weight"], sd[name + ".bias"] = d["kernel"].T, d["bias"]

    def norm(name, d):
        sd[name + ".weight"], sd[name + ".bias"] = d["scale"], d["bias"]

    e = "image_encoder"
    sd[f"{e}.patch_embed.proj.weight"] = enc["patch_embed"]["kernel"].permute(3, 2, 0, 1)
    sd[f"{e}.patch_embed.proj.bias"] = enc["patch_embed"]["bias"]
    sd[f"{e}.pos_embed"] = enc["pos_embed"]
    for i in range(sum(k.startswith("block") for k in enc)):
        b, o = enc[f"block{i}"], f"{e}.blocks.{i}"
        norm(f"{o}.norm1", b["norm1"])
        norm(f"{o}.norm2", b["norm2"])
        dense(f"{o}.attn.qkv", b["attn"]["qkv"])
        dense(f"{o}.attn.proj", b["attn"]["proj"])
        sd[f"{o}.attn.rel_pos_h"] = b["attn"]["rel_pos_h"]
        sd[f"{o}.attn.rel_pos_w"] = b["attn"]["rel_pos_w"]
        dense(f"{o}.mlp.lin1", b["mlp_lin1"])
        dense(f"{o}.mlp.lin2", b["mlp_lin2"])
    sd[f"{e}.neck.0.weight"] = enc["neck0"]["kernel"].permute(3, 2, 0, 1)
    sd[f"{e}.neck.1.weight"], sd[f"{e}.neck.1.bias"] = enc["neck_ln0_scale"], enc["neck_ln0_bias"]
    sd[f"{e}.neck.2.weight"] = enc["neck1"]["kernel"].permute(3, 2, 0, 1)
    sd[f"{e}.neck.3.weight"], sd[f"{e}.neck.3.bias"] = enc["neck_ln1_scale"], enc["neck_ln1_bias"]

    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = pe["pe_gaussian"]
    for i in range(4):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = pe["point_embeddings"][i][None]
    sd["prompt_encoder.not_a_point_embed.weight"] = pe["not_a_point"][None]
    sd["prompt_encoder.no_mask_embed.weight"] = pe["no_mask"][None]

    def attn(name, d):
        for t in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{name}.{t}", d[t])

    m = "mask_decoder"
    for i in range(2):
        b, o = dec[f"tw{i}"], f"{m}.transformer.layers.{i}"
        attn(f"{o}.self_attn", b["self_attn"])
        attn(f"{o}.cross_attn_token_to_image", b["cross_t2i"])
        attn(f"{o}.cross_attn_image_to_token", b["cross_i2t"])
        for n in range(1, 5):
            norm(f"{o}.norm{n}", b[f"norm{n}"])
        dense(f"{o}.mlp.lin1", b["mlp_lin1"])
        dense(f"{o}.mlp.lin2", b["mlp_lin2"])
    attn(f"{m}.transformer.final_attn_token_to_image", dec["final_t2i"])
    norm(f"{m}.transformer.norm_final_attn", dec["final_norm"])
    sd[f"{m}.iou_token.weight"] = dec["iou_token"]
    sd[f"{m}.mask_tokens.weight"] = dec["mask_tokens"]
    for j, name in ((0, "up0"), (3, "up1")):  # flax HWIO, flipped -> torch IOHW
        sd[f"{m}.output_upscaling.{j}.weight"] = dec[name]["kernel"].flip(0, 1).permute(2, 3, 0, 1)
        sd[f"{m}.output_upscaling.{j}.bias"] = dec[name]["bias"]
    sd[f"{m}.output_upscaling.1.weight"] = dec["up_ln_scale"]
    sd[f"{m}.output_upscaling.1.bias"] = dec["up_ln_bias"]
    n_tokens = sum(k.startswith("hyper") and k.endswith("_lin0") for k in dec)
    for i in range(n_tokens):
        for j in range(3):
            dense(f"{m}.output_hypernetworks_mlps.{i}.layers.{j}", dec[f"hyper{i}_lin{j}"])
    for j in range(3):
        dense(f"{m}.iou_prediction_head.layers.{j}", dec[f"iou_lin{j}"])
    return {k: v.contiguous() for k, v in sd.items()}


def preprocess_image(img, img_size: int, device=None):
    """Resize the longest side to img_size (as `jax.image.resize` linear
    does), normalize with SAM's pixel statistics and zero-pad square.
    img: (H, W, 3) uint8 / float array or tensor. Returns the padded
    (S, S, 3) float32 tensor on `device` (the image's own if None) and the
    resized (rh, rw)."""
    x = (img if isinstance(img, torch.Tensor) else torch.tensor(np.asarray(img)))
    x = x.to(device=device, dtype=torch.float32)
    h, w = x.shape[:2]
    scale = img_size / max(h, w)
    rh, rw = int(round(h * scale)), int(round(w * scale))
    x = resize_bilinear(x.permute(2, 0, 1)[None], (rh, rw))[0].permute(1, 2, 0)
    mean = torch.from_numpy(PIXEL_MEAN).to(x.device)
    std = torch.from_numpy(PIXEL_STD).to(x.device)
    x = F.pad((x - mean) / std, (0, 0, 0, img_size - rw, 0, img_size - rh))
    return x, (rh, rw)
