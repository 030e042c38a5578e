"""CLIP text encoder: the text tower, its BPE tokenizer and the encoder
that fusion, evaluation and the viewer query.

Port of semantic_gaussians_tpu.models.clip_text. The tower is OpenAI CLIP's
text transformer (token + learned positional embedding, pre-LN residual
blocks with causal self-attention and QuickGELU MLPs, final LayerNorm,
pooling at each row's EOT token = its largest id, projection into the
joint space). Its `state_dict()` keys are OpenAI `clip`'s
(`token_embedding.weight`, `transformer.resblocks.N.attn.in_proj_weight`,
`text_projection`, ...), so an OpenAI checkpoint loads with
`load_state_dict`; `hf_to_openai` maps a Hugging Face CLIPModel's text keys
onto them.

Widths come from the state dict (`CLIPTextTower.from_state_dict`: width
from the token embedding, heads = width // 64 as OpenAI's
`clip.build_model` takes them, layers from the block count, embed_dim from
the projection). The JAX encoder builds the ViT-B/32 tower (512 wide)
whatever its checkpoint holds, so it cannot load the 768-wide ViT-L/14
text tower its own fusion config names; the port does not copy that.

Tokenization: stdlib `re` in place of the `regex` package (absent where
the port runs). Letters are `[^\\W\\d_]+` and numbers `\\d`, where `regex`
has `\\p{L}+` and `\\p{N}`: the two differ on numeric characters that are
not decimal digits (superscripts, fractions, Roman numerals, circled
digits: `regex` makes each a one-character number token, `re` joins it to
the letters around it) and on the ASCII separators U+001C-U+001F (`re`
treats them as white space). tests/test_torch_clip.py names such strings.
"""
from __future__ import annotations

import functools
import gzip
import html
import re
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device
from .common import float32_state, load_torch_state_dict

CONTEXT_LENGTH = 77
SOT_TOKEN = 49406
EOT_TOKEN = 49407
LN_EPS = 1e-5  # OpenAI CLIP's and the JAX text tower's LayerNorm epsilon


def quick_gelu(x):
    """OpenAI CLIP's activation x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class PackedAttention(nn.Module):
    """Multi-head self-attention with OpenAI's packed projection
    (`in_proj_weight` [3W, W], `in_proj_bias`, `out_proj`): softmax of
    (q / sqrt(hd)) k^T, optionally causal, times v."""

    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):  # [B, T, W]
        b, t, w = x.shape
        hd = w // self.heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).split(w, dim=-1)
        q, k, v = (z.reshape(b, t, self.heads, hd).transpose(1, 2) for z in (q, k, v))
        attn = (q * hd ** -0.5) @ k.transpose(-1, -2)
        if self.causal:
            mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
            attn = attn.masked_fill(~mask, float("-inf"))
        out = (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(b, t, w)
        return self.out_proj(out)


class ResidualBlock(nn.Module):
    """OpenAI CLIP's pre-LN block: x + attn(ln_1 x), then + mlp(ln_2 x)."""

    def __init__(self, width: int, heads: int, causal: bool, eps: float):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=eps)
        self.attn = PackedAttention(width, heads, causal)
        self.ln_2 = nn.LayerNorm(width, eps=eps)
        self.mlp = nn.Module()
        self.mlp.c_fc = nn.Linear(width, 4 * width)
        self.mlp.c_proj = nn.Linear(4 * width, width)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp.c_proj(quick_gelu(self.mlp.c_fc(self.ln_2(x))))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, causal: bool, eps: float):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualBlock(width, heads, causal, eps) for _ in range(layers))

    def forward(self, x):
        for blk in self.resblocks:
            x = blk(x)
        return x


def count_blocks(sd, prefix: str) -> int:
    """Number of `<prefix>N.` blocks in a state dict."""
    idx = {int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix)}
    return 1 + max(idx) if idx else 0


class CLIPTextTower(nn.Module):
    """OpenAI CLIP text transformer; ViT-B/32 defaults (512-d joint space).
    [B, T] int token ids -> [B, embed_dim] unnormalized features."""

    def __init__(self, vocab_size: int = 49408, context_length: int = CONTEXT_LENGTH,
                 width: int = 512, layers: int = 12, heads: int = 8, embed_dim: int = 512):
        super().__init__()
        self.embed_dim = embed_dim
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = Transformer(width, layers, heads, causal=True, eps=LN_EPS)
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    @classmethod
    def from_state_dict(cls, sd) -> "CLIPTextTower":
        """The tower the text keys of an OpenAI CLIP state dict describe,
        with those weights in float32. Keys of the image tower (`visual.*`) and the
        scalars of a full CLIP model (`logit_scale`, `input_resolution`,
        `context_length`, `vocab_size`) are not the text tower's and are
        left out."""
        sd = float32_state({k: v for k, v in sd.items()
                            if k in _TEXT_KEYS or k.startswith("transformer.")})
        vocab, width = sd["token_embedding.weight"].shape
        with torch.device("meta"):  # no init of weights about to be replaced
            tower = cls(vocab_size=vocab, context_length=sd["positional_embedding"].shape[0],
                        width=width, layers=count_blocks(sd, "transformer.resblocks."),
                        heads=width // 64, embed_dim=sd["text_projection"].shape[1])
        tower.load_state_dict(sd, assign=True)
        return tower

    def forward(self, token_ids):
        x = self.token_embedding(token_ids) + self.positional_embedding[: token_ids.shape[1]]
        x = self.ln_final(self.transformer(x))
        pooled = x[torch.arange(x.shape[0], device=x.device), token_ids.argmax(dim=-1)]
        return pooled @ self.text_projection


_TEXT_KEYS = ("token_embedding.weight", "positional_embedding", "ln_final.weight",
              "ln_final.bias", "text_projection")


def hf_to_openai(sd) -> dict:
    """A Hugging Face CLIPModel / CLIPTextModelWithProjection state dict's
    text tower in OpenAI's names (q/k/v packed into in_proj, the
    projection transposed). Other keys are left out."""
    out = {
        "token_embedding.weight": sd["text_model.embeddings.token_embedding.weight"],
        "positional_embedding": sd["text_model.embeddings.position_embedding.weight"],
        "ln_final.weight": sd["text_model.final_layer_norm.weight"],
        "ln_final.bias": sd["text_model.final_layer_norm.bias"],
        "text_projection": sd["text_projection.weight"].T.contiguous(),
    }
    for i in range(count_blocks(sd, "text_model.encoder.layers.")):
        h, o = f"text_model.encoder.layers.{i}", f"transformer.resblocks.{i}"
        out[f"{o}.attn.in_proj_weight"] = torch.cat(
            [sd[f"{h}.self_attn.{t}_proj.weight"] for t in "qkv"])
        out[f"{o}.attn.in_proj_bias"] = torch.cat(
            [sd[f"{h}.self_attn.{t}_proj.bias"] for t in "qkv"])
        for a, b in (("attn.out_proj", "self_attn.out_proj"), ("ln_1", "layer_norm1"),
                     ("ln_2", "layer_norm2"), ("mlp.c_fc", "mlp.fc1"),
                     ("mlp.c_proj", "mlp.fc2")):
            for p in ("weight", "bias"):
                out[f"{o}.{a}.{p}"] = sd[f"{h}.{b}.{p}"]
    return out


def state_from_flax(variables) -> dict:
    """The JAX text tower's variables (a tree of arrays) -> this tower's
    state dict (OpenAI names)."""
    from .common import tensor_tree

    p = tensor_tree(variables["params"] if "params" in variables else variables)
    sd = {
        "token_embedding.weight": p["token_embedding"]["embedding"],
        "positional_embedding": p["positional_embedding"],
        "ln_final.weight": p["ln_final"]["scale"], "ln_final.bias": p["ln_final"]["bias"],
        "text_projection": p["text_projection"],
    }
    for i in range(sum(k.startswith("block_") for k in p)):
        b, o = p[f"block_{i}"], f"transformer.resblocks.{i}"
        sd.update({
            f"{o}.ln_1.weight": b["ln_1"]["scale"], f"{o}.ln_1.bias": b["ln_1"]["bias"],
            f"{o}.ln_2.weight": b["ln_2"]["scale"], f"{o}.ln_2.bias": b["ln_2"]["bias"],
            f"{o}.attn.in_proj_weight": b["attn"]["qkv"]["kernel"].T,
            f"{o}.attn.in_proj_bias": b["attn"]["qkv"]["bias"],
            f"{o}.attn.out_proj.weight": b["attn"]["out"]["kernel"].T,
            f"{o}.attn.out_proj.bias": b["attn"]["out"]["bias"],
            f"{o}.mlp.c_fc.weight": b["fc"]["kernel"].T, f"{o}.mlp.c_fc.bias": b["fc"]["bias"],
            f"{o}.mlp.c_proj.weight": b["proj"]["kernel"].T,
            f"{o}.mlp.c_proj.bias": b["proj"]["bias"],
        })
    return {k: v.contiguous() for k, v in sd.items()}


# --------------------------------------------------------------------------
# Tokenizer (CLIP BPE over a local merges file, bpe_simple_vocab_16e6.txt.gz)
# --------------------------------------------------------------------------


@functools.lru_cache()
def bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# `regex`'s [\p{L}]+ | [\p{N}] | [^\s\p{L}\p{N}]+ in stdlib `re` (module
# docstring: where the two differ). `_` is neither a letter nor a number.
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE)


class SimpleTokenizer:
    """CLIP's byte-pair encoder. From the public merges file
    (`bpe_path`, bpe_simple_vocab_16e6.txt.gz: a header line, then merges)
    the vocabulary is built as CLIP builds it; a Hugging Face tokenizer
    directory gives `encoder` (vocab.json) and `merges` (merges.txt)
    instead."""

    def __init__(self, bpe_path: Optional[str] = None, *, encoder: Optional[dict] = None,
                 merges: Optional[Sequence[tuple]] = None):
        if bpe_path is not None:
            lines = gzip.open(bpe_path, "rt", encoding="utf-8").read().split("\n")
            merges = [tuple(m.split()) for m in lines[1: 49152 - 256 - 2 + 1]]
            vocab = list(bytes_to_unicode().values())
            vocab = vocab + [v + "</w>" for v in vocab]
            vocab += ["".join(m) for m in merges] + ["<|startoftext|>", "<|endoftext|>"]
            encoder = dict(zip(vocab, range(len(vocab))))
        self.encoder = encoder
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}

    def _bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list:
        text = re.sub(r"\s+", " ", html.unescape(html.unescape(text)).strip().lower())
        ids = []
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids


@functools.lru_cache(maxsize=4)
def cached_tokenizer(bpe_path: str) -> SimpleTokenizer:
    """The merges parse is ~49k lines: one tokenizer per path."""
    return SimpleTokenizer(bpe_path)


def tokenize(texts: Sequence[str], bpe_path=None, context_length: int = CONTEXT_LENGTH, *,
             tokenizer: Optional[SimpleTokenizer] = None, sot: int = SOT_TOKEN,
             eot: int = EOT_TOKEN) -> np.ndarray:
    """[K, context_length] int64 ids: SOT, the text's BPE ids, EOT, zeros
    (clip.tokenize; a text longer than the context keeps its first
    context_length - 1 ids and ends in EOT)."""
    tok = tokenizer or cached_tokenizer(str(bpe_path))
    out = np.zeros((len(texts), context_length), np.int64)
    for i, t in enumerate(texts):
        ids = [sot] + tok.encode(t) + [eot]
        if len(ids) > context_length:
            ids = ids[: context_length - 1] + [eot]
        out[i, : len(ids)] = ids
    return out


def load_checkpoint(path) -> dict:
    """An OpenAI-layout text state dict from a torch checkpoint (a plain
    state dict, a full CLIP model or a TorchScript archive) or from the JAX
    package's .npz of flattened variables ('params/a/b' keys)."""
    path = Path(path)
    if path.suffix == ".npz":
        tree: dict = {}
        for k, v in np.load(path).items():
            *parents, leaf = k.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = v
        return state_from_flax(tree)
    return load_torch_state_dict(path)


class CLIPTextEncoder:
    """Predictor-protocol text side: L2-normalized [K, embed_dim] features
    of label strings (tokenized with the local merges file `bpe_path`) or
    of pre-tokenized ids. Counterpart of the JAX package's
    JaxCLIPTextEncoder; runs on CUDA unless `device` asks for the CPU."""

    def __init__(self, checkpoint_path=None, bpe_path=None, *, tower: Optional[CLIPTextTower] = None,
                 state_dict: Optional[dict] = None, tokenizer: Optional[SimpleTokenizer] = None,
                 sot: int = SOT_TOKEN, eot: int = EOT_TOKEN, device=None):
        self.device = resolve_device(device)
        if tower is None:
            if state_dict is None:
                if checkpoint_path is None:
                    raise ValueError("need checkpoint_path, state_dict or tower")
                state_dict = load_checkpoint(checkpoint_path)
            tower = CLIPTextTower.from_state_dict(state_dict)
        self.tower = tower.to(self.device).eval()
        self.embedding_dim = self.tower.embed_dim
        self.bpe_path, self.tokenizer, self.sot, self.eot = bpe_path, tokenizer, sot, eot

    @torch.inference_mode()
    def encode_tokens(self, token_ids) -> np.ndarray:
        ids = torch.as_tensor(np.asarray(token_ids), dtype=torch.long, device=self.device)
        x = self.tower(ids)
        return (x / x.norm(dim=-1, keepdim=True)).float().cpu().numpy()

    def tokenize(self, labelset: Sequence[str]) -> np.ndarray:
        if self.tokenizer is None and self.bpe_path is None:
            raise ValueError("string input needs bpe_path (bpe_simple_vocab_16e6.txt.gz); "
                             "use encode_tokens for pre-tokenized input")
        ctx = self.tower.positional_embedding.shape[0]
        return tokenize(labelset, self.bpe_path, ctx, tokenizer=self.tokenizer,
                        sot=self.sot, eot=self.eot)

    def extract_text_feature(self, labelset: Sequence[str]) -> np.ndarray:
        if isinstance(labelset, str):
            labelset = labelset.split(",")
        return self.encode_tokens(self.tokenize(list(labelset)))

    def extract_image_feature(self, img_path, img_size):
        raise NotImplementedError("text-only provider")
