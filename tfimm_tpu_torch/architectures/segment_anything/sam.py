"""Segment Anything Model (SAM); mirror of
tfimm_tpu/architectures/segment_anything/sam.py.

ViT-Det image encoder + prompt encoder + two-way-transformer mask decoder.
``forward`` takes a dict of images (B, H, W, C), points, labels, boxes and
masks, as the JAX package's does. Parameter names are Meta's, so the JAX
package's parameters load through ``state_dict_from_jax``. The image
encoder's attention runs the ``flash_attention_relpos`` kernel on the card
(see ``image_encoder.py``); the rest is plain PyTorch in both packages.
The config's ``transform_weights`` resizes the position embedding and the
global blocks' rel-pos tables when ``transfer_weights`` moves the weights
to another input size. The automatic mask generator, over the predictor,
is ``amg.py · SAMAutomaticMaskGenerator``.

Paper: Segment Anything, https://arxiv.org/abs/2304.02643.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional, Tuple

import torch

from tfimm_tpu_torch.architectures.segment_anything.image_encoder import (
    ImageEncoder,
)
from tfimm_tpu_torch.architectures.segment_anything.mask_decoder import (
    MaskDecoder,
)
from tfimm_tpu_torch.architectures.segment_anything.prompt_encoder import (
    PromptEncoder,
)
from tfimm_tpu_torch.architectures.segment_anything.transformer import (
    TwoWayTransformer,
)
from tfimm_tpu_torch.core import Context
from tfimm_tpu_torch.models.base import Model
from tfimm_tpu_torch.models.config import ModelConfig
from tfimm_tpu_torch.models.registry import register_model
from tfimm_tpu_torch.ops.resize import resize_linear
from tfimm_tpu_torch.utils.constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
)

__all__ = ["SegmentAnythingModel", "SegmentAnythingModelConfig"]


@dataclass
class SegmentAnythingModelConfig(ModelConfig):
    nb_classes: int = 0  # segmentation model: no classifier
    in_channels: int = 3
    input_size: Tuple[int, int] = (1024, 1024)
    fixed_input_size: bool = True
    embed_dim: int = 256
    nb_multimask_outputs: int = 3
    mask_threshold: float = 0.0
    encoder_patch_size: int = 16
    encoder_embed_dim: int = 768
    encoder_nb_blocks: int = 12
    encoder_nb_heads: int = 12
    encoder_mlp_ratio: float = 4.0
    encoder_drop_rate: float = 0.0
    encoder_attn_drop_rate: float = 0.0
    encoder_drop_path_rate: float = 0.0
    encoder_norm_layer: str = "layer_norm_eps_1e-6"
    encoder_act_layer: str = "gelu"
    encoder_qkv_bias: bool = True
    encoder_global_attn_indices: Tuple = (2, 5, 8, 11)
    encoder_window_size: int = 14
    prompt_mask_hidden_dim: int = 16
    decoder_nb_blocks: int = 2
    decoder_nb_heads: int = 8
    decoder_mlp_channels: int = 2048
    decoder_iou_head_depth: int = 3
    decoder_iou_hidden_dim: int = 256
    mean: Tuple[float, float, float] = IMAGENET_DEFAULT_MEAN
    std: Tuple[float, float, float] = IMAGENET_DEFAULT_STD
    first_conv: str = "image_encoder.patch_embed.proj"

    @property
    def transform_weights(self):
        transforms = {"image_encoder.pos_embed": _transform_pos_embed}
        for j in self.encoder_global_attn_indices:
            prefix = f"image_encoder.blocks.{j}.attn.rel_pos"
            transforms[prefix + "_h"] = partial(_transform_rel_pos, axis=0)
            transforms[prefix + "_w"] = partial(_transform_rel_pos, axis=1)
        return transforms


def _transform_rel_pos(model, rel_pos, target_cfg, axis: int):
    """A global block's rel-pos table resized (bilinear, as
    ``jax.image.resize``) to ``target_cfg``'s grid along ``axis``."""
    grid_dim = target_cfg.input_size[axis] // target_cfg.encoder_patch_size
    return resize_linear(rel_pos.float(), (2 * grid_dim - 1, rel_pos.shape[1]))


def _transform_pos_embed(model, pos_embed, target_cfg):
    """The (1, gh, gw, D) position embedding resized (bilinear) to
    ``target_cfg``'s grid."""
    grid = (target_cfg.input_size[0] // target_cfg.encoder_patch_size,
            target_cfg.input_size[1] // target_cfg.encoder_patch_size)
    return resize_linear(pos_embed.float(), (1, *grid, pos_embed.shape[-1]))


class SegmentAnythingModel(Model):
    cfg_class = SegmentAnythingModelConfig

    def __init__(self, cfg: SegmentAnythingModelConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg)
        g = generator
        self.image_encoder = ImageEncoder(
            input_size=cfg.input_size,
            fixed_input_size=cfg.fixed_input_size,
            patch_size=cfg.encoder_patch_size,
            in_channels=cfg.in_channels,
            embed_dim=cfg.encoder_embed_dim,
            nb_blocks=cfg.encoder_nb_blocks,
            nb_heads=cfg.encoder_nb_heads,
            mlp_ratio=cfg.encoder_mlp_ratio,
            out_channels=cfg.embed_dim,
            qkv_bias=cfg.encoder_qkv_bias,
            norm_layer=cfg.encoder_norm_layer,
            act_layer=cfg.encoder_act_layer,
            use_abs_pos=True,
            use_rel_pos=True,
            global_attn_indices=cfg.encoder_global_attn_indices,
            window_size=cfg.encoder_window_size,
            drop_rate=cfg.encoder_drop_rate,
            attn_drop_rate=cfg.encoder_attn_drop_rate,
            drop_path_rate=cfg.encoder_drop_path_rate,
            generator=g,
        )
        self.prompt_encoder = PromptEncoder(cfg.embed_dim,
                                            cfg.prompt_mask_hidden_dim, "gelu",
                                            generator=g)
        self.mask_decoder = MaskDecoder(
            transformer=TwoWayTransformer(
                embed_dim=cfg.embed_dim,
                nb_blocks=cfg.decoder_nb_blocks,
                nb_heads=cfg.decoder_nb_heads,
                mlp_dim=cfg.decoder_mlp_channels,
                attention_downsample_rate=2,
                act_layer="relu",
                generator=g,
            ),
            embed_dim=cfg.embed_dim,
            nb_multimask_outputs=cfg.nb_multimask_outputs,
            iou_head_depth=cfg.decoder_iou_head_depth,
            iou_head_hidden_dim=cfg.decoder_iou_hidden_dim,
            act_layer="gelu",
            generator=g,
        )

    def grid_size(self, input_size: Optional[Tuple[int, int]] = None):
        input_size = input_size or self.cfg.input_size
        return (input_size[0] // self.cfg.encoder_patch_size,
                input_size[1] // self.cfg.encoder_patch_size)

    def mask_size(self, input_size: Optional[Tuple[int, int]] = None):
        g = self.grid_size(input_size)
        return 4 * g[0], 4 * g[1]

    @property
    def mask_threshold(self) -> float:
        return self.cfg.mask_threshold

    def get_image_pe(self, image_embeddings: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = image_embeddings.shape
        pe = self.prompt_encoder.get_dense_pe((h, w))
        return pe[None].expand(n, *pe.shape).to(image_embeddings.dtype)

    def postprocess_logits(self, logits: torch.Tensor,
                           input_size: Tuple[int, int],
                           return_logits: bool) -> torch.Tensor:
        """(N, K, h, w) mask logits -> (N, K, *input_size) in f32, resized as
        ``jax.image.resize(..., "bilinear")`` does; thresholded to booleans
        unless ``return_logits``."""
        n, k, _, _ = logits.shape
        masks = resize_linear(logits.float(), (n, k, *input_size))
        if not return_logits:
            masks = masks > self.mask_threshold
        return masks

    def forward_features(self, x) -> torch.Tensor:
        images = x["images"] if isinstance(x, dict) else x
        return self.image_encoder(images)

    def forward_prompts(self, image_embeddings: torch.Tensor,
                        inputs: Dict[str, torch.Tensor],
                        multimask_output: bool = False):
        """The prompt encoder and the mask decoder on image embeddings
        (N, H, W, C): (mask logits, scores)."""
        sparse, dense = self.prompt_encoder(
            {"points": inputs["points"], "labels": inputs["labels"],
             "boxes": inputs["boxes"], "masks": inputs["masks"]})
        return self.mask_decoder(
            {"image_embeddings": image_embeddings,
             "image_pe": self.get_image_pe(image_embeddings),
             "sparse_embeddings": sparse.to(image_embeddings.dtype),
             "dense_embeddings": dense.to(image_embeddings.dtype)},
            multimask_output=multimask_output)

    def forward(self, x, *, multimask_output: bool = False,
                return_logits: bool = False, return_features: bool = False,
                features_only: bool = False,
                generator: Optional[torch.Generator] = None):
        """``x``: images, points, labels, boxes and masks. Returns (masks at
        the image size, scores, low-resolution logits), or the image
        embeddings with ``features_only``; with ``return_features`` also the
        captured features, keyed by ``feature_names``."""
        ctx = Context(training=self.training, generator=generator,
                      capture_features=return_features)
        with ctx:
            image_embeddings = self.forward_features(x)
            if features_only:
                out = image_embeddings
            else:
                logits, scores = self.forward_prompts(image_embeddings, x,
                                                      multimask_output)
                masks = self.postprocess_logits(
                    logits, input_size=tuple(x["images"].shape[1:3]),
                    return_logits=return_logits)
                out = (masks, scores, logits)
        return (out, ctx.features) if return_features else out

    @property
    def feature_names(self):
        return tuple(["patch_embedding"]
                     + [f"block_{j}" for j in range(self.cfg.encoder_nb_blocks)]
                     + ["neck"])


# -- variant registrations ---------------------------------------------------
# The same variants, with the same configs, as the JAX package's sam.py.

def _register(name, url_file, **kwargs):
    def fn():
        url = ("[pytorch]https://dl.fbaipublicfiles.com/segment_anything/"
               + url_file)
        return SegmentAnythingModel, SegmentAnythingModelConfig(
            name=name, url=url, **kwargs)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__module__ = __name__
    globals()[name] = fn
    register_model(fn)


_register("sam_vit_b", "sam_vit_b_01ec64.pth", encoder_embed_dim=768,
          encoder_nb_blocks=12, encoder_nb_heads=12,
          encoder_global_attn_indices=(2, 5, 8, 11))
_register("sam_vit_l", "sam_vit_l_0b3195.pth", encoder_embed_dim=1024,
          encoder_nb_blocks=24, encoder_nb_heads=16,
          encoder_global_attn_indices=(5, 11, 17, 23))
_register("sam_vit_h", "sam_vit_h_4b8939.pth", encoder_embed_dim=1280,
          encoder_nb_blocks=32, encoder_nb_heads=16,
          encoder_global_attn_indices=(7, 15, 23, 31))
