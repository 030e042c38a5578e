"""LSeg dense vision-language features: a ViT-L/16 backbone tapped at four
depths, the DPT reassemble and fusion decoder, and a 1x1 head into CLIP's
512-d joint space.

Port of semantic_gaussians_tpu.models.lseg:
  * backbone (timm vit_large_patch16_384): patch conv, class token, learned
    position embedding (its grid resized for other inputs as
    `jax.image.resize` bilinear resizes it), pre-LN blocks with erf GELU,
    LayerNorm epsilon 1e-6; taps after blocks (5, 11, 17, 23);
  * readout 'project' (class token concatenated to each token, 2W -> W,
    GELU), then act_postprocess1-4: 1x1 conv to (256, 512, 1024, 1024) and
    a resample to strides 4, 8, 16, 32 (transposed conv k4s4, k2s2,
    identity, conv k3s2p1);
  * scratch.layerN_rn 3x3 convs to 256; four fusion blocks coarse to fine
    (residual conv units with eval-mode BatchNorm, epsilon 1e-5; x2
    bilinear align_corners=True; 1x1 out conv); head1 1x1 -> 512 and a
    final x2 align-corners upsample.

`LSegNet.state_dict()` keys are the public LSeg checkpoint's (demo_e200.ckpt)
without its `net.` prefix. `split_checkpoint` sorts a checkpoint's keys:
the network's; the bundled CLIP ViT-B/32 (`clip_pretrained.*`, whose text
tower becomes the predictor's text encoder); and, left out knowingly, the
keys no forward pass reads: `scratch.refinenet4.resConfUnit1.*` (the
coarsest fusion block has no skip input), the backbone's final norm and
classifier head (`pretrained.model.norm.*`, `.head.*`, `.pre_logits.*`),
`logit_scale`, and the bundled CLIP's image tower and logit scale.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device
from .clip_text import count_blocks
from .common import float32_state, load_torch_state_dict, resize_bilinear
from .predictors import load_image

LN_EPS = 1e-6  # timm ViT
BN_EPS = 1e-5
IMAGE_MEAN = 0.5  # LSeg's norm_mean / norm_std
IMAGE_STD = 0.5
BASE_SIZE = 520  # long-side pre-scale
CROP_SIZE = 480  # sliding-window crop


@dataclasses.dataclass(frozen=True)
class LSegConfig:
    patch: int = 16
    width: int = 1024
    layers: int = 24
    heads: int = 16
    taps: Tuple[int, ...] = (5, 11, 17, 23)
    native_grid: int = 24
    reassemble_ch: Tuple[int, ...] = (256, 512, 1024, 1024)
    features: int = 256
    out_ch: int = 512  # CLIP joint space
    use_bn: bool = True

    @staticmethod
    def from_state_dict(sd) -> "LSegConfig":
        """The config an LSegNet state dict describes: widths and depth from
        the weights, heads = width // 64 (timm's ViT-L/16 and B/16), the
        taps at the ends of the four quarters of the blocks."""
        width, _, patch, _ = sd["pretrained.model.patch_embed.proj.weight"].shape
        layers = count_blocks(sd, "pretrained.model.blocks.")
        return LSegConfig(
            patch=patch, width=width, layers=layers, heads=width // 64,
            taps=tuple(layers * (i + 1) // 4 - 1 for i in range(4)),
            native_grid=round((sd["pretrained.model.pos_embed"].shape[1] - 1) ** 0.5),
            reassemble_ch=tuple(sd[f"pretrained.act_postprocess{i + 1}.3.weight"].shape[0]
                                for i in range(4)),
            features=sd["scratch.layer1_rn.weight"].shape[0],
            out_ch=sd["scratch.head1.weight"].shape[0],
            use_bn="scratch.refinenet1.resConfUnit2.bn1.weight" in sd)

    @staticmethod
    def tiny(out_ch: int = 32) -> "LSegConfig":
        """Test-sized variant (same topology)."""
        return LSegConfig(patch=16, width=64, layers=4, heads=4, taps=(0, 1, 2, 3),
                          native_grid=4, reassemble_ch=(16, 24, 32, 32), features=24,
                          out_ch=out_ch)


def resize_bilinear_ac(x, oh: int, ow: int):
    """Bilinear resize of an NCHW map with align_corners=True (the fusion
    blocks' and the head's upsampling)."""
    return F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=True)


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x):
        b, t, w = x.shape
        hd = w // self.heads
        q, k, v = (z.reshape(b, t, self.heads, hd).transpose(1, 2)
                   for z in self.qkv(x).split(w, dim=-1))
        attn = ((q * hd ** -0.5) @ k.transpose(-1, -2)).softmax(dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, t, w))


class _Mlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = nn.Linear(width, 4 * width)
        self.fc2 = nn.Linear(4 * width, width)


class ViTBlock(nn.Module):
    """timm pre-LN block (erf GELU)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = _Attention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = _Mlp(width)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class _PatchEmbed(nn.Module):
    def __init__(self, c: LSegConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, c.width, c.patch, stride=c.patch)


class ViTTapped(nn.Module):
    """ViT backbone returning the token sequences after the `taps` blocks."""

    def __init__(self, c: LSegConfig):
        super().__init__()
        self.c = c
        self.patch_embed = _PatchEmbed(c)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.width))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + c.native_grid ** 2, c.width))
        self.blocks = nn.ModuleList(ViTBlock(c.width, c.heads) for _ in range(c.layers))

    def forward(self, x):  # (B, 3, H, W), H and W multiples of the patch
        c = self.c
        x = self.patch_embed.proj(x)
        b, _, gh, gw = x.shape
        x = torch.cat([self.cls_token.expand(b, 1, -1), x.flatten(2).transpose(1, 2)], dim=1)
        pos = self.pos_embed
        if (gh, gw) != (c.native_grid, c.native_grid):
            grid = pos[:, 1:].reshape(1, c.native_grid, c.native_grid, c.width).permute(0, 3, 1, 2)
            grid = resize_bilinear(grid, (gh, gw)).permute(0, 2, 3, 1).reshape(1, gh * gw, c.width)
            pos = torch.cat([pos[:, :1], grid], dim=1)
        x = x + pos
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in c.taps:
                outs.append(x)
        return outs, (gh, gw)


class _ProjectReadout(nn.Module):
    """Concat the class token onto each token, 2W -> W, GELU."""

    def __init__(self, width: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * width, width), nn.GELU())

    def forward(self, tokens):
        cls = tokens[:, :1].expand_as(tokens[:, 1:])
        return self.project(torch.cat([tokens[:, 1:], cls], dim=-1))


def _act_postprocess(width: int, out_ch: int, scale: int) -> nn.Sequential:
    """act_postprocessN: 0 readout, 3 the 1x1 conv, 4 the resample (the
    public layout's indices; 1 and 2 are the reshape to a map)."""
    if scale == 4:
        resample = nn.ConvTranspose2d(out_ch, out_ch, 4, stride=4)
    elif scale == 2:
        resample = nn.ConvTranspose2d(out_ch, out_ch, 2, stride=2)
    elif scale == -2:
        resample = nn.Conv2d(out_ch, out_ch, 3, stride=2, padding=1)
    else:
        resample = nn.Identity()
    return nn.Sequential(_ProjectReadout(width), nn.Identity(), nn.Identity(),
                         nn.Conv2d(width, out_ch, 1), resample)


class _Pretrained(nn.Module):
    def __init__(self, c: LSegConfig):
        super().__init__()
        self.model = ViTTapped(c)
        for i, s in enumerate((4, 2, 1, -2)):
            setattr(self, f"act_postprocess{i + 1}", _act_postprocess(c.width, c.reassemble_ch[i], s))


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> bn -> relu -> conv3x3 -> bn, plus the input."""

    def __init__(self, features: int, use_bn: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, bias=not use_bn)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=not use_bn)
        if use_bn:
            self.bn1 = nn.BatchNorm2d(features, eps=BN_EPS)
            self.bn2 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.use_bn = use_bn

    def forward(self, x):
        out = self.conv1(F.relu(x))
        if self.use_bn:
            out = self.bn1(out)
        out = self.conv2(F.relu(out))
        if self.use_bn:
            out = self.bn2(out)
        return x + out


class FeatureFusion(nn.Module):
    """skip via resConfUnit1 (absent in the coarsest block), resConfUnit2,
    x2 align-corners upsample, 1x1 out conv."""

    def __init__(self, features: int, use_bn: bool, skip: bool):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(features, use_bn)
        self.resConfUnit2 = ResidualConvUnit(features, use_bn)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize_bilinear_ac(x, x.shape[2] * 2, x.shape[3] * 2)
        return self.out_conv(x)


class _Scratch(nn.Module):
    def __init__(self, c: LSegConfig):
        super().__init__()
        for i in range(4):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(c.reassemble_ch[i], c.features, 3, padding=1, bias=False))
            setattr(self, f"refinenet{i + 1}", FeatureFusion(c.features, c.use_bn, skip=i < 3))
        self.head1 = nn.Conv2d(c.features, c.out_ch, 1)


class LSegNet(nn.Module):
    """LSeg's image tower: (B, H, W, 3) normalized -> (B, H, W, out_ch)
    unnormalized per-pixel features."""

    def __init__(self, cfg: LSegConfig = LSegConfig()):
        super().__init__()
        self.cfg = cfg
        self.pretrained = _Pretrained(cfg)
        self.scratch = _Scratch(cfg)

    def forward(self, x):
        taps, (gh, gw) = self.pretrained.model(x.permute(0, 3, 1, 2))
        maps = []
        for i, t in enumerate(taps):
            post = getattr(self.pretrained, f"act_postprocess{i + 1}")
            m = post[0](t).transpose(1, 2).reshape(t.shape[0], -1, gh, gw)
            maps.append(post[4](post[3](m)))
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(maps[i]) for i in range(4)]
        path = s.refinenet4(rn[3])
        path = s.refinenet3(path, rn[2])
        path = s.refinenet2(path, rn[1])
        path = s.refinenet1(path, rn[0])
        feats = s.head1(path)
        feats = resize_bilinear_ac(feats, feats.shape[2] * 2, feats.shape[3] * 2)
        return feats.permute(0, 2, 3, 1)


_IGNORED = ("scratch.refinenet4.resConfUnit1.", "pretrained.model.norm.",
            "pretrained.model.head.", "pretrained.model.pre_logits.", "logit_scale")


def split_checkpoint(sd):
    """A public LSeg checkpoint's keys (with or without `net.`) -> (the
    network's state dict, the bundled CLIP's OpenAI-layout state dict, the
    sorted keys left out). Raises on a key of none of these groups."""
    net, clip, ignored, unknown = {}, {}, [], []
    for k, v in sd.items():
        k = k[4:] if k.startswith("net.") else k
        if k.startswith("clip_pretrained."):
            clip[k[len("clip_pretrained."):]] = v
        elif k.startswith(("pretrained.", "scratch.")) and not k.startswith(_IGNORED):
            net[k] = v
        elif k.startswith(_IGNORED):
            ignored.append(k)
        else:
            unknown.append(k)
    if unknown:
        raise ValueError(f"LSeg checkpoint: unexpected keys {sorted(unknown)[:8]}")
    ignored += [f"clip_pretrained.{k}" for k in clip if not _is_text_key(k)]
    return net, clip, sorted(ignored)


def _is_text_key(k: str) -> bool:
    return not (k.startswith("visual.") or k == "logit_scale")


def clip_text_state_from_lseg(sd) -> dict:
    """The CLIP text tower's state (OpenAI names) bundled in an LSeg
    checkpoint (`net.clip_pretrained.*`)."""
    return {k: v for k, v in split_checkpoint(sd)[1].items() if _is_text_key(k)}


def state_from_flax(variables) -> dict:
    """The JAX LSegNet's variables ({'params', 'batch_stats'}) -> this
    network's state dict. flax's transposed convs hold their kernels
    spatially flipped against torch's (lseg.py `_convt`): undone here."""
    from .common import tensor_tree

    p = tensor_tree(variables["params"])
    stats = tensor_tree(variables.get("batch_stats", {}))
    sd = {}

    def conv(name, d, bias=True):
        sd[name + ".weight"] = d["kernel"].permute(3, 2, 0, 1)
        if bias and "bias" in d:
            sd[name + ".bias"] = d["bias"]

    def dense(name, d):
        sd[name + ".weight"], sd[name + ".bias"] = d["kernel"].T, d["bias"]

    vit, m = p["vit"], "pretrained.model"
    conv(f"{m}.patch_embed.proj", vit["patch_embed"])
    sd[f"{m}.cls_token"] = vit["cls_token"]
    sd[f"{m}.pos_embed"] = vit["pos_embed"]
    for i in range(sum(k.startswith("block_") for k in vit)):
        b, o = vit[f"block_{i}"], f"{m}.blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{o}.{n}.weight"], sd[f"{o}.{n}.bias"] = b[n]["scale"], b[n]["bias"]
        dense(f"{o}.attn.qkv", b["attn"]["qkv"])
        dense(f"{o}.attn.proj", b["attn"]["proj"])
        dense(f"{o}.mlp.fc1", b["fc1"])
        dense(f"{o}.mlp.fc2", b["fc2"])
    for i in range(4):
        b, o = p[f"reassemble_{i}"], f"pretrained.act_postprocess{i + 1}"
        dense(f"{o}.0.project.0", b["readout"]["project"])
        conv(f"{o}.3", b["conv"])
        if i in (0, 1):  # flax HWIO, flipped -> torch IOHW
            sd[f"{o}.4.weight"] = b["resample"]["kernel"].flip(0, 1).permute(2, 3, 0, 1)
            sd[f"{o}.4.bias"] = b["resample"]["bias"]
        elif i == 3:
            conv(f"{o}.4", b["resample"])
    for i in range(4):
        conv(f"scratch.layer{i + 1}_rn", p[f"layer{i + 1}_rn"])
        b, o = p[f"refinenet{i + 1}"], f"scratch.refinenet{i + 1}"
        st = stats.get(f"refinenet{i + 1}", {})
        conv(f"{o}.out_conv", b["out_conv"])
        for flax_name, name in (("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2")):
            if flax_name not in b:
                continue
            for j in (1, 2):
                conv(f"{o}.{name}.conv{j}", b[flax_name][f"conv{j}"])
                if f"bn{j}" in b[flax_name]:
                    bn, s = b[flax_name][f"bn{j}"], st[flax_name][f"bn{j}"]
                    q = f"{o}.{name}.bn{j}"
                    sd[f"{q}.weight"], sd[f"{q}.bias"] = bn["scale"], bn["bias"]
                    sd[f"{q}.running_mean"], sd[f"{q}.running_var"] = s["mean"], s["var"]
                    sd[f"{q}.num_batches_tracked"] = torch.tensor(0)
    conv("scratch.head1", p["head1"])
    return {k: v.contiguous() for k, v in sd.items()}


class LSegPredictor:
    """Predictor2D provider backed by the port's LSeg towers (embedding_dim
    512): `extract_image_feature` returns an [H, W, 512] L2-normalized map
    at img_size; text features come from the checkpoint's bundled CLIP text
    tower. The network's config is read from the checkpoint (the JAX
    predictor takes LSegConfig() whatever the file holds). Runs on CUDA
    unless `device` asks for the CPU."""

    def __init__(self, checkpoint_path=None, *, net: Optional[LSegNet] = None,
                 text_encoder=None, base_size: int = BASE_SIZE, crop_size: int = CROP_SIZE,
                 bpe_path=None, device=None):
        self.device = resolve_device(device)
        self.base_size, self.crop_size = base_size, crop_size
        self.text_encoder = text_encoder
        if net is None:
            if checkpoint_path is None:
                raise ValueError("need checkpoint_path or net")
            net_sd, clip_sd, _ = split_checkpoint(
                load_torch_state_dict(checkpoint_path, full_unpickle=True))
            with torch.device("meta"):  # no init of weights about to be replaced
                net = LSegNet(LSegConfig.from_state_dict(net_sd))
            net.load_state_dict(float32_state(net_sd), assign=True)
            text_sd = {k: v for k, v in clip_sd.items() if _is_text_key(k)}
            if self.text_encoder is None and text_sd:
                from .clip_text import CLIPTextEncoder

                self.text_encoder = CLIPTextEncoder(state_dict=text_sd, bpe_path=bpe_path,
                                                    device=self.device)
        self.net = net.to(self.device).eval()
        self.cfg = net.cfg
        self.embedding_dim = net.cfg.out_ch

    def _run(self, x: np.ndarray) -> torch.Tensor:
        """The net on normalized (B, H, W, 3) images -> (B, C, H, W)."""
        return self.net(torch.from_numpy(x).to(self.device)).permute(0, 3, 1, 2)

    def _normalized(self, img, h, w):
        return (_resize_image_np(img, h, w).astype(np.float32) / 255.0 - IMAGE_MEAN) / IMAGE_STD

    @torch.inference_mode()
    def extract_image_feature(self, img_path, img_size=None, sliding: bool = False) -> np.ndarray:
        """[H, W, 512] normalized features of a path or RGB array: resize to
        img_size (W, H), normalize (0.5 / 0.5), pre-scale the long side to
        base_size snapped to multiples of 32, run the net, resize the
        features back (align corners). sliding=True runs the reference's
        multi-crop evaluator instead of one whole-image pass."""
        img = load_image(img_path)
        if img_size is not None:
            w, h = int(img_size[0]), int(img_size[1])
        else:
            h, w = img.shape[:2]
        if sliding:
            feats = self._sliding_features(img, h, w)
        else:
            if h > w:
                ih = self.base_size
                iw = max(32, int(round(w * self.base_size / h / 32)) * 32)
            else:
                iw = self.base_size
                ih = max(32, int(round(h * self.base_size / w / 32)) * 32)
            ih, iw = -(-ih // 32) * 32, -(-iw // 32) * 32
            feats = self._run(self._normalized(img, ih, iw)[None])
            feats = resize_bilinear_ac(feats, h, w)[0]
        feats = feats / feats.norm(dim=0, keepdim=True).clamp(min=1e-8)
        return feats.permute(1, 2, 0).float().cpu().numpy()

    def _sliding_features(self, img: np.ndarray, h: int, w: int) -> torch.Tensor:
        """The reference's multi-crop evaluator at scales=[1.0], no flip:
        the long side resized to base_size; if it fits in one crop, one
        padded pass; else the short side padded to crop_size and crops of
        crop_size on a stride of 2/3 crop, run as one batch, their features
        summed and divided by the visit count, cropped back and resized to
        (h, w) with align corners. Padding is normalized black.
        Returns (C, h, w) unnormalized features."""
        crop, base = self.crop_size, self.base_size
        stride = int(crop * 2.0 / 3.0)
        if h > w:
            height, width = base, int(1.0 * w * base / h + 0.5)
        else:
            height, width = int(1.0 * h * base / w + 0.5), base
        x = self._normalized(img, height, width)
        pad_val = (0.0 - IMAGE_MEAN) / IMAGE_STD
        if max(height, width) <= crop:
            xp = np.full((crop, crop, 3), pad_val, np.float32)
            xp[:height, :width] = x
            feats = self._run(xp[None])[:, :, :height, :width]
            return resize_bilinear_ac(feats, h, w)[0]
        ph, pw = max(height, crop), max(width, crop)
        h_grids = int(np.ceil(1.0 * (ph - crop) / stride)) + 1
        w_grids = int(np.ceil(1.0 * (pw - crop) / stride)) + 1
        gh, gw = (h_grids - 1) * stride + crop, (w_grids - 1) * stride + crop
        xp = np.full((gh, gw, 3), pad_val, np.float32)
        xp[:height, :width] = x
        crops, spans = [], []
        for idh in range(h_grids):
            for idw in range(w_grids):
                h0, w0 = idh * stride, idw * stride
                crops.append(xp[h0: h0 + crop, w0: w0 + crop])
                spans.append((h0, w0, min(h0 + crop, ph), min(w0 + crop, pw)))
        outs = self._run(np.stack(crops))
        acc = torch.zeros((outs.shape[1], ph, pw), device=outs.device)
        cnt = torch.zeros((1, ph, pw), device=outs.device)
        for o, (h0, w0, h1, w1) in zip(outs, spans):
            acc[:, h0:h1, w0:w1] += o[:, : h1 - h0, : w1 - w0]
            cnt[:, h0:h1, w0:w1] += 1.0
        feats = (acc / cnt)[:, :height, :width]
        return resize_bilinear_ac(feats[None], h, w)[0]

    def extract_text_feature(self, labelset: Sequence[str]) -> np.ndarray:
        if self.text_encoder is None:
            raise ValueError("no text tower loaded; pass text_encoder")
        return np.asarray(self.text_encoder.extract_text_feature(labelset))


def _resize_image_np(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """PIL bilinear resize of an RGB uint8 image to (h, w)."""
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))
