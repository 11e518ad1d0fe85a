"""Vision Transformer (counterpart of
``paddle_tpu/vision/models/vision_transformer.py``, the PaddleClas ViT
family): a stride-P conv patch embedding, a class token, learned position
embeddings, pre-norm blocks and a linear head on the class token.

Attention goes through :func:`...nn.functional.scaled_dot_product_attention`
in paddle's ``[B, S, H, D]`` layout, unmasked: on the card it runs the
flash kernels (K1 forward; K2a / K2b backward) at the ragged length
``S = (img_size / patch)^2 + 1`` (197 for ViT-B/16 at 224), non-causal.
With ``attn_drop_rate > 0`` in training it takes the plain attention, as
the reference sends dropout to XLA.  ``VisionTransformer`` and the
``vit_*`` constructors take ``device=`` (None: the card; ``"cpu"``) and
``dtype=``.
"""

from __future__ import annotations

import torch

from ... import nn
from ...device import resolve_device
from ...nn import functional as F
from ...nn import initializer as I
from ...nn.layers.common import make_parameter

__all__ = ["VisionTransformer", "vit_b_16", "vit_b_32", "vit_l_16",
           "vit_s_16"]


class PatchEmbed(torch.nn.Module):
    """img ``[B, 3, H, W]`` -> tokens ``[B, HW / P^2, D]`` by a stride-P
    conv."""

    def __init__(self, img_size=224, patch_size=16, in_chans=3, embed_dim=768):
        super().__init__()
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = nn.Conv2D(in_chans, embed_dim, patch_size,
                              stride=patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)      # [B, N, D]


class Mlp(torch.nn.Module):
    def __init__(self, dim, hidden, drop=0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = nn.Dropout(drop)

    def forward(self, x):
        return self.drop(self.fc2(self.drop(F.gelu(self.fc1(x)))))


class Block(torch.nn.Module):
    """Pre-norm transformer block; q / k / v are views of one ``qkv``
    projection."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, drop=0.0,
                 attn_drop=0.0, epsilon=1e-6):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, epsilon=epsilon)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, epsilon=epsilon)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop)
        self.attn_drop = attn_drop
        self.drop = nn.Dropout(drop)

    def forward(self, x):
        B, S = x.shape[:2]
        q, k, v = (t.reshape(B, S, self.num_heads, self.head_dim)
                   for t in self.qkv(self.norm1(x)).chunk(3, dim=-1))
        att = F.scaled_dot_product_attention(
            q, k, v, dropout_p=self.attn_drop, training=self.training)
        x = x + self.drop(self.proj(att.reshape(B, S, -1)))
        return x + self.mlp(self.norm2(x))


class VisionTransformer(torch.nn.Module):
    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 class_num=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, drop_rate=0.0, attn_drop_rate=0.0,
                 epsilon=1e-6, num_classes=None, device=None, dtype=None):
        super().__init__()
        if num_classes is not None:     # torchvision-style alias
            class_num = num_classes
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim)
        n = self.patch_embed.num_patches
        self.cls_token = make_parameter([1, 1, embed_dim], None,
                                        I.TruncatedNormal(std=0.02))
        self.pos_embed = make_parameter([1, n + 1, embed_dim], None,
                                        I.TruncatedNormal(std=0.02))
        self.pos_drop = nn.Dropout(drop_rate)
        self.blocks = nn.LayerList([
            Block(embed_dim, num_heads, mlp_ratio, drop_rate, attn_drop_rate,
                  epsilon) for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, epsilon=epsilon)
        self.head = (nn.Linear(embed_dim, class_num) if class_num > 0
                     else nn.Identity())
        self.to(device=resolve_device(device), dtype=dtype)

    def forward_features(self, x):
        x = self.patch_embed(x)                              # [B, N, D]
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed     # dtypes promote
        x = self.pos_drop(x)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 0]                            # class token

    def forward(self, x):
        return self.head(self.forward_features(x))


def vit_s_16(**kw):
    kw.setdefault("embed_dim", 384)
    kw.setdefault("depth", 12)
    kw.setdefault("num_heads", 6)
    return VisionTransformer(patch_size=16, **kw)


def vit_b_16(**kw):
    return VisionTransformer(patch_size=16, **kw)


def vit_b_32(**kw):
    return VisionTransformer(patch_size=32, **kw)


def vit_l_16(**kw):
    kw.setdefault("embed_dim", 1024)
    kw.setdefault("depth", 24)
    kw.setdefault("num_heads", 16)
    return VisionTransformer(patch_size=16, **kw)
