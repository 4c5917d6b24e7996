"""ConvNeXt; mirror of tfimm_tpu/architectures/convnext.py.

Patchify stem, blocks of 7x7 depthwise conv -> LayerNorm -> MLP (Dense or
1x1 conv) -> layer scale (gamma) -> drop path -> residual, and stages that
downsample with a norm and a strided patchify conv. Parameter names are
timm's (``stem.0``, ``stages.1.downsample.1``,
``stages.0.blocks.0.conv_dw``, ``head.fc``), so timm checkpoints load with
``load_state_dict``.

At inference each block's LN -> fc1 -> GELU -> fc2 -> gamma -> +shortcut
runs as one call of ``convnext_mlp`` after the depthwise conv (the
hand-written kernel on the card, its plain version on the CPU), gated as the
JAX package gates its Pallas kernel (``ConvNeXtBlock._mlp_kernel_ok``). With
``TFIMM_TPU_FUSED_CONVNEXT=1``, the JAX package's opt-in, read from the same
variable, a bf16 block at inference runs whole, depthwise conv included, as
one call of ``convnext_block`` (``ConvNeXtBlock.fused_kernel_ok``); that
function keeps the conv's output in f32 and takes the tanh GELU, as the
Pallas kernel does.

Both kernels take fc1's and fc2's effective weights, ``_kernel(x.dtype)``:
a LoRA layer (``architectures/lora``) merges its update there. The JAX
package hands its kernels the raw ``kernel`` leaves, so its kernel path
drops a LoRA update that its XLA path applies; the port computes what
the XLA path computes.

Paper: A ConvNet for the 2020s, https://arxiv.org/abs/2201.03545.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from tfimm_tpu_torch.core import capture_feature, current_context
from tfimm_tpu_torch.models.base import Model
from tfimm_tpu_torch.models.config import ModelConfig
from tfimm_tpu_torch.models.registry import register_model
from tfimm_tpu_torch.ops.basic import Dense
from tfimm_tpu_torch.ops.conv import Conv2d, DepthwiseConv2d
from tfimm_tpu_torch.ops.kernels.convnext_block import convnext_block
from tfimm_tpu_torch.ops.kernels.convnext_mlp import convnext_mlp
from tfimm_tpu_torch.ops.kernels.dispatch import KERNEL_DTYPES, log_dispatch
from tfimm_tpu_torch.ops.mlp import MLP, ConvMLP
from tfimm_tpu_torch.ops.norm import norm_layer_factory
from tfimm_tpu_torch.ops.stochastic import drop_path, dropout
from tfimm_tpu_torch.quant import any_quantized
from tfimm_tpu_torch.utils.constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)

__all__ = ["ConvNeXt", "ConvNeXtConfig", "ConvNeXtBlock", "ConvNeXtStage"]


@dataclass
class ConvNeXtConfig(ModelConfig):
    nb_classes: int = 1000
    in_channels: int = 3
    input_size: Tuple[int, int] = (224, 224)
    patch_size: int = 4
    embed_dim: Tuple = (96, 192, 384, 768)
    nb_blocks: Tuple = (3, 3, 9, 3)
    mlp_ratio: float = 4.0
    conv_mlp_block: bool = False
    # Regularization
    drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    # Other parameters
    norm_layer: str = "layer_norm_eps_1e-6"
    act_layer: str = "gelu"
    init_scale: float = 1e-6
    # Parameters for inference
    crop_pct: float = 0.875
    interpolation: str = "bicubic"
    # Preprocessing
    mean: Tuple[float, float, float] = IMAGENET_DEFAULT_MEAN
    std: Tuple[float, float, float] = IMAGENET_DEFAULT_STD
    # Weight transfer
    first_conv: str = "stem.0"
    classifier: str = "head.fc"


class ConvNeXtBlock(nn.Module):
    """DwConv7x7 -> LN -> MLP (Dense or 1x1 conv) -> layer scale -> drop
    path -> residual, on NHWC maps."""

    def __init__(self, embed_dim, mlp_ratio, conv_mlp_block, drop_rate,
                 drop_path_rate, norm_layer, act_layer, init_scale, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_dw = DepthwiseConv2d(embed_dim, 7, generator=generator)
        self.norm = norm_layer_factory(norm_layer)(embed_dim)
        mlp_cls = ConvMLP if conv_mlp_block else MLP
        self.mlp = mlp_cls(embed_dim, int(mlp_ratio * embed_dim),
                           act_layer=act_layer, drop_rate=drop_rate,
                           weight_std=0.02, generator=generator)
        self.gamma = nn.Parameter(torch.full((embed_dim,), float(init_scale)))
        self.drop_path_rate = drop_path_rate
        self.conv_mlp_block = conv_mlp_block
        self.drop_rate = drop_rate
        self.norm_name = norm_layer
        self.act_name = act_layer

    def _autograd_records(self, x: torch.Tensor) -> bool:
        return torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))

    def fused_kernel_ok(self, x: torch.Tensor) -> bool:
        """Gate for ``convnext_block``, as the JAX package's
        ``_use_fused_kernel``: the opt-in ``TFIMM_TPU_FUSED_CONVNEXT=1``, off
        by default; not ``TFIMM_TPU_EXACT_GELU=1`` (the kernel takes the tanh
        GELU); inference, the Dense MLP and no dropout; x in bf16. Like the
        JAX gate it does not check the norm or the activation. It declines
        f16, which the JAX gate takes (the port has no f16 kernel), and has
        no VMEM estimate (the TPU's layout) and no backend test (on the CPU
        the kernel's plain version runs). The kernel has no backward, so
        where autograd records the block it takes the per-op path. As the
        JAX block's ``__call__``, it declines where fc1 or fc2 is int8
        (``any_quantized``): the kernel reads both weights raw."""
        if os.environ.get("TFIMM_TPU_FUSED_CONVNEXT", "0") != "1":
            return False
        if any_quantized(self.mlp.fc1, self.mlp.fc2):
            return False
        if os.environ.get("TFIMM_TPU_EXACT_GELU", "0") == "1":
            return False
        if current_context().training or self.conv_mlp_block or self.drop_rate:
            return False
        return x.dtype == torch.bfloat16 and not self._autograd_records(x)

    def _mlp_kernel_ok(self, x: torch.Tensor) -> bool:
        """Gate for ``convnext_mlp``, as the JAX package's: inference (drop
        path and dropout are the identity), Dense MLP, LayerNorm + GELU. The
        kernel has no backward, so where autograd records the block it takes
        the eager composition, as the JAX package runs its XLA twin under
        differentiation. As the JAX block's ``__call__``, it declines where
        fc1 or fc2 is int8."""
        if current_context().training or self.conv_mlp_block or self.drop_rate:
            return False
        if any_quantized(self.mlp.fc1, self.mlp.fc2):
            return False
        if not (self.norm_name.startswith("layer_norm")
                and self.act_name == "gelu") or x.dtype not in KERNEL_DTYPES:
            return False
        return not self._autograd_records(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mlp = self.mlp
        if self.fused_kernel_ok(x):
            log_dispatch("convnext_block")
            return convnext_block(
                x.contiguous(), self.conv_dw.weight, self.conv_dw.bias,
                self.norm.weight, self.norm.bias, mlp.fc1._kernel(x.dtype),
                mlp.fc1.bias, mlp.fc2._kernel(x.dtype), mlp.fc2.bias,
                self.gamma, self.norm.eps)
        shortcut = x
        x = self.conv_dw(x)
        if self._mlp_kernel_ok(x):
            log_dispatch("convnext_mlp")
            c = x.shape[-1]
            out = convnext_mlp(x.reshape(-1, c), shortcut.reshape(-1, c),
                               self.norm.weight, self.norm.bias,
                               mlp.fc1._kernel(x.dtype), mlp.fc1.bias,
                               mlp.fc2._kernel(x.dtype), mlp.fc2.bias,
                               self.gamma, self.norm.eps)
            return out.reshape(shortcut.shape)
        ctx = current_context()
        x = self.mlp(self.norm(x))
        x = x * self.gamma.to(x.dtype)
        x = drop_path(x, self.drop_path_rate, ctx.training, ctx.generator)
        return x + shortcut


class ConvNeXtStage(nn.Module):
    """Optional (norm, strided patchify conv) downsample, then the blocks."""

    def __init__(self, stride, in_dim, embed_dim, nb_blocks, mlp_ratio,
                 conv_mlp_block, drop_rate, drop_path_rates, norm_layer,
                 act_layer, init_scale, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.downsample = None
        if stride > 1:
            self.downsample = nn.ModuleList([
                norm_layer_factory(norm_layer)(in_dim),
                Conv2d(in_dim, embed_dim, stride, weight_std=0.02,
                       zero_bias=True, generator=generator),
            ])
        self.blocks = nn.ModuleList(
            ConvNeXtBlock(embed_dim, mlp_ratio, conv_mlp_block, drop_rate,
                          float(drop_path_rates[i]), norm_layer, act_layer,
                          init_scale, generator=generator)
            for i in range(nb_blocks))

    def forward(self, x: torch.Tensor, stage_idx: int) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample[1](self.downsample[0](x))
            capture_feature(f"stage_{stage_idx}/downsample", x)
        for i, block in enumerate(self.blocks):
            x = block(x)
            capture_feature(f"stage_{stage_idx}/block_{i}", x)
        return x


class ConvNeXt(Model):
    cfg_class = ConvNeXtConfig

    def __init__(self, cfg: ConvNeXtConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        norm = norm_layer_factory(cfg.norm_layer)
        self.stem = nn.ModuleList([
            Conv2d(cfg.in_channels, cfg.embed_dim[0], cfg.patch_size,
                   weight_std=0.02, zero_bias=True, generator=g),
            norm(cfg.embed_dim[0]),
        ])
        dpr = np.linspace(0.0, cfg.drop_path_rate, sum(cfg.nb_blocks))
        dpr = np.split(dpr, np.cumsum(cfg.nb_blocks))
        self.stages = nn.ModuleList(
            ConvNeXtStage(
                stride=2 if j > 0 else 1, in_dim=cfg.embed_dim[max(j - 1, 0)],
                embed_dim=cfg.embed_dim[j], nb_blocks=cfg.nb_blocks[j],
                mlp_ratio=cfg.mlp_ratio, conv_mlp_block=cfg.conv_mlp_block,
                drop_rate=cfg.drop_rate, drop_path_rates=dpr[j],
                norm_layer=cfg.norm_layer, act_layer=cfg.act_layer,
                init_scale=cfg.init_scale, generator=g)
            for j in range(len(cfg.nb_blocks)))
        self.nb_features = cfg.embed_dim[-1]
        self.head = nn.ModuleDict({"norm": norm(self.nb_features)})
        if cfg.nb_classes > 0:
            self.head["fc"] = Dense(self.nb_features, cfg.nb_classes,
                                    weight_std=0.02, generator=g)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem[1](self.stem[0](x))
        capture_feature("stem", x)
        for j, stage in enumerate(self.stages):
            x = stage(x, j)
        capture_feature("conv_features", x)
        return x

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        ctx = current_context()
        x = self.head["norm"](x.mean(dim=(1, 2)))
        x = dropout(x, self.cfg.drop_rate, ctx.training, ctx.generator)
        if "fc" in self.head:
            x = self.head["fc"](x)
        capture_feature("logits", x)
        return x

    @property
    def feature_names(self):
        names = ["stem"]
        for j, n in enumerate(self.cfg.nb_blocks):
            if j > 0:
                names.append(f"stage_{j}/downsample")
            names += [f"stage_{j}/block_{i}" for i in range(n)]
        return tuple(names + ["conv_features", "logits"])


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as tfimm_tpu/architectures/convnext.py.

def _register(name, **kwargs):
    def fn():
        return ConvNeXt, ConvNeXtConfig(name=name, url="[timm]", **kwargs)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    globals()[name] = fn
    register_model(fn)


_DIMS = {
    "tiny": ((96, 192, 384, 768), (3, 3, 9, 3)),
    "small": ((96, 192, 384, 768), (3, 3, 27, 3)),
    "base": ((128, 256, 512, 1024), (3, 3, 27, 3)),
    "large": ((192, 384, 768, 1536), (3, 3, 27, 3)),
    "xlarge": ((256, 512, 1024, 2048), (3, 3, 27, 3)),
}

for _size in ("tiny", "small", "base", "large"):
    _d, _b = _DIMS[_size]
    _register(f"convnext_{_size}", embed_dim=_d, nb_blocks=_b)
for _size in ("tiny", "small", "base", "large", "xlarge"):
    _d, _b = _DIMS[_size]
    _register(f"convnext_{_size}_in22ft1k", embed_dim=_d, nb_blocks=_b)
    _register(f"convnext_{_size}_384_in22ft1k", input_size=(384, 384),
              embed_dim=_d, nb_blocks=_b)
    _register(f"convnext_{_size}_in22k", nb_classes=21841, embed_dim=_d,
              nb_blocks=_b)
