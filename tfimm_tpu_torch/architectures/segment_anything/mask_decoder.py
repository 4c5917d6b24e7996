"""SAM mask decoder; mirror of
tfimm_tpu/architectures/segment_anything/mask_decoder.py.

Mask and IoU tokens through the two-way transformer, transposed-conv
upscaling, hypernetwork MLPs producing per-mask dynamic filters, and the
IoU quality head. No kernel runs here in either package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tfimm_tpu_torch.architectures.segment_anything.common import Embedding
from tfimm_tpu_torch.architectures.segment_anything.transformer import (
    TwoWayTransformer,
)
from tfimm_tpu_torch.ops.basic import Dense, act_layer_factory
from tfimm_tpu_torch.ops.conv import ConvTranspose2d
from tfimm_tpu_torch.ops.norm import norm_layer_factory

__all__ = ["MaskDecoder", "OutputUpscaling", "DecoderMLP", "ConvTranspose2d"]


class OutputUpscaling(nn.Module):
    """4x upscaling by two stride-2 transposed convs. Parameters keep Meta's
    sequential names: 0 (transposed conv), 1 (LayerNorm), 3 (transposed
    conv)."""

    def __init__(self, embed_dim: int, act_layer: str, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.act = act_layer_factory(act_layer)
        norm = norm_layer_factory("layer_norm_eps_1e-6")
        self.add_module("0", ConvTranspose2d(embed_dim, embed_dim // 4, 2, 2,
                                             generator=g))
        self.add_module("1", norm(embed_dim // 4))
        self.add_module("3", ConvTranspose2d(embed_dim // 4, embed_dim // 8,
                                             2, 2, generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layer = self._modules
        x = self.act(layer["1"](layer["0"](x)))
        return self.act(layer["3"](x))


class DecoderMLP(nn.Module):
    """ReLU MLP. Parameters: layers.{j}.*."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 nb_layers: int, sigmoid_output: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (nb_layers - 1)
        outs = [hidden_dim] * (nb_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Dense(d, o, generator=generator)
                                    for d, o in zip(dims, outs))
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for j, layer in enumerate(self.layers):
            x = layer(x)
            if j < len(self.layers) - 1:
                x = F.relu(x)
        if self.sigmoid_output:
            x = torch.sigmoid(x)
        return x


class MaskDecoder(nn.Module):
    """Parameters: iou_token.weight (1, D), mask_tokens.weight (K + 1, D),
    transformer.*, output_upscaling.*, output_hypernetworks_mlps.{j}.*,
    iou_prediction_head.*."""

    def __init__(self, transformer: TwoWayTransformer, embed_dim: int,
                 nb_multimask_outputs: int, act_layer: str,
                 iou_head_depth: int, iou_head_hidden_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.embed_dim = embed_dim
        self.nb_mask_tokens = nb_multimask_outputs + 1
        self.iou_token = Embedding(1, embed_dim, g)
        self.mask_tokens = Embedding(self.nb_mask_tokens, embed_dim, g)
        self.transformer = transformer
        self.output_upscaling = OutputUpscaling(embed_dim, act_layer,
                                                generator=g)
        self.output_hypernetworks_mlps = nn.ModuleList(
            DecoderMLP(embed_dim, embed_dim, embed_dim // 8, 3, generator=g)
            for _ in range(self.nb_mask_tokens))
        self.iou_prediction_head = DecoderMLP(
            embed_dim, iou_head_hidden_dim, self.nb_mask_tokens,
            iou_head_depth, generator=g)

    def predict_masks(self, image_embeddings, image_pe, sparse_embeddings,
                      dense_embeddings):
        n = image_embeddings.shape[0]
        output_tokens = torch.cat([self.iou_token.weight,
                                   self.mask_tokens.weight], dim=0)
        output_tokens = output_tokens[None].expand(
            n, *output_tokens.shape).to(sparse_embeddings.dtype)
        tokens = torch.cat([output_tokens, sparse_embeddings], dim=1)

        tokens, image_embeddings = self.transformer(
            tokens, image_embeddings + dense_embeddings, image_pe)
        iou_token = tokens[:, 0]
        mask_tokens = tokens[:, 1:1 + self.nb_mask_tokens]

        upscaled = self.output_upscaling(image_embeddings)
        hyper_in = torch.stack([mlp(mask_tokens[:, j]) for j, mlp in
                                enumerate(self.output_hypernetworks_mlps)],
                               dim=1)                            # (N, K+1, C/8)
        n, h, w, c = upscaled.shape
        masks = torch.matmul(hyper_in, upscaled.reshape(n, h * w, c)
                             .transpose(1, 2)).reshape(n, -1, h, w)
        return masks, self.iou_prediction_head(iou_token)

    def forward(self, inputs: Dict[str, torch.Tensor],
                multimask_output: bool = False):
        """``inputs``: image_embeddings and image_pe (N, H, W, C),
        sparse_embeddings (N, M, C), dense_embeddings (N, H, W, C). Returns
        (mask logits (N, K, 4H, 4W), IoU predictions (N, K)): the K
        multimask outputs, or the single-mask output."""
        masks, iou_pred = self.predict_masks(
            inputs["image_embeddings"], inputs["image_pe"],
            inputs["sparse_embeddings"], inputs["dense_embeddings"])
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, 0:1], iou_pred[:, 0:1]
