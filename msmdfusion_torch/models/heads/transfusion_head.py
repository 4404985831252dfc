"""TransFusion detection head (transformer decoder over BEV features).

Counterpart of the JAX package's ``models/heads/transfusion_head.py``
(reference mmdet3d/models/dense_heads/transfusion_head.py): heatmap query
initialisation with per-class local-maximum NMS, a transformer decoder
with learned position embeddings, the FFN prediction branches, the
decode of ``get_bboxes``, and for training the Hungarian target
assignment (the device auction of ``ops/matching.py``), the gaussian
heatmap targets and the losses. In training mode the batch norms take the
batch's moments and dropout draws from the ``torch.Generator`` passed to
``forward``.

With ``fuse_img`` (TransFusion-LC) and image features given, the head
also runs the reference's image fusion (JAX ``:283-463``): the BEV
features cross-attend, view after view, to the height-collapsed image
columns (image-to-BEV); the query heatmap is the mean of the LiDAR and the
fused maps' sigmoids; after the LiDAR decoder every proposal that projects
onto an image is refined by a cross-attention to that view's features
under a gaussian mask around its centre (a later view wins a proposal two
views see), and the fused FFN predicts from the refined and the LiDAR
query; proposals on no image keep the LiDAR predictions, and the losses
count only proposals on an image. Without image features the head is
TransFusion-L's.

Module and parameter names are the reference's (``shared_conv``,
``heatmap_head``, ``class_encoding``, ``decoder.{i}``,
``prediction_heads.{i}``; with ``fuse_img`` also ``shared_conv_img``,
``heatmap_head_img``, ``fc``, ``decoder.{L}`` the fusion decoder,
``decoder.{L + 1 + v}`` view ``v``'s image-to-BEV decoder and
``prediction_heads.{L}`` the fused FFN, for ``L`` decoder layers;
pointwise convs are Conv1d with kernel 1), while the decoder runs
channels-last like the JAX package and applies the Conv1d weights as
linear maps.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.boxes import corners_3d
from ...core.gaussian import draw_heatmap, gaussian_radius
from ...core.iou3d import boxes_iou_3d
from ...ops.matching import assign_proposals
from ...parallel.distributed import all_sum, batch_rand, gather_rows
from ...registry import BBOX_CODERS, HEADS
from ...utils.timing import section
from ..layers import (BatchNorm1d, Conv1d, Conv2d, ConvModule, LayerNorm,
                      Linear, batch_norm_last, cudnn_enabled, get_activation,
                      pointwise, promoted)
from ..losses import (clip_sigmoid, gaussian_focal_loss, l1_loss,
                      sigmoid_focal_loss)


def dropout(x, p: float, training: bool, generator=None):
    """Inverted dropout with rate ``p`` in training mode; the mask draws
    from ``generator`` (the default generator when None; a
    ``SharedGenerator``: the global batch's mask, this rank's rows)."""
    if not training or p <= 0:
        return x
    keep = batch_rand(x.shape, generator, x.device, x.dtype) >= p
    return torch.where(keep, x / (1 - p), 0.0)


class PositionEmbeddingLearned(nn.Module):
    """Two-layer pointwise MLP with batch norm (reference :25-41)."""

    def __init__(self, input_channel: int, num_pos_feats: int = 288):
        super().__init__()
        self.position_embedding_head = nn.Sequential(
            Conv1d(input_channel, num_pos_feats, 1),
            BatchNorm1d(num_pos_feats),
            nn.ReLU(inplace=True),
            Conv1d(num_pos_feats, num_pos_feats, 1))

    def forward(self, xyz):
        """xyz [B, P, D] -> [B, P, num_pos_feats]."""
        head = self.position_embedding_head
        x = batch_norm_last(head[1], pointwise(head[0], xyz))
        return pointwise(head[3], F.relu(x))


class MultiheadAttention(nn.Module):
    """Multi-head attention, channels-last, with ``nn.MultiheadAttention``'s
    parameter names (``in_proj_weight`` [3E, E], ``out_proj``)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, query, key, value, attn_mask=None, generator=None):
        """query [B, P, C], key/value [B, S, C] -> [B, P, C]; in training
        mode dropout on the attention weights."""
        b, p, c = query.shape
        s = key.shape[1]
        h = self.num_heads
        hd = c // h
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(*promoted(query, wq, bq)).reshape(b, p, h, hd) \
            .transpose(1, 2)
        k = F.linear(*promoted(key, wk, bk)).reshape(b, s, h, hd) \
            .transpose(1, 2)
        v = F.linear(*promoted(value, wv, bv)).reshape(b, s, h, hd) \
            .transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if attn_mask is not None:
            logits = logits + attn_mask
        weights = dropout(torch.softmax(logits, dim=-1), self.dropout,
                          self.training, generator)
        out = torch.matmul(weights, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, p, c))


class TransformerDecoderLayer(nn.Module):
    """Self-attention, cross-attention and FFN with learned position
    embeddings (reference :44-122); dropout in training mode."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, activation: str = 'relu',
                 cross_only: bool = False, pos_dim: int = 2):
        super().__init__()
        self.cross_only = cross_only
        self.dropout = dropout
        if not cross_only:
            self.self_attn = MultiheadAttention(d_model, nhead, dropout)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.activation = get_activation(activation)
        self.self_posembed = PositionEmbeddingLearned(pos_dim, d_model)
        self.cross_posembed = PositionEmbeddingLearned(pos_dim, d_model)

    def forward(self, query, key, query_pos, key_pos, attn_mask=None,
                generator=None):
        """query [B, P, C], key [B, S, C], query_pos [B, P, D],
        key_pos [B, S, D] -> [B, P, C]."""
        def drop(x):
            return dropout(x, self.dropout, self.training, generator)

        qpe = self.self_posembed(query_pos)
        kpe = self.cross_posembed(key_pos)
        if not self.cross_only:
            q = query + qpe
            query = self.norm1(query + drop(self.self_attn(
                q, q, q, generator=generator)))
        k = key + kpe
        query = self.norm2(query + drop(self.multihead_attn(
            query + qpe, k, k, attn_mask=attn_mask, generator=generator)))
        ff = self.linear2(drop(self.activation(self.linear1(query))))
        return self.norm3(query + drop(ff))


class FFN(nn.Module):
    """Multi-branch pointwise prediction head (reference FFN, :507-590):
    per branch ``num_conv - 1`` ConvModules (Conv1d + BN1d + ReLU) and a
    final Conv1d."""

    def __init__(self, in_channels: int, heads: Dict[str, Tuple[int, int]],
                 head_conv: int = 64, init_bias: float = -2.19):
        super().__init__()
        self.heads = dict(heads)
        for head, (classes, num_conv) in self.heads.items():
            layers = []
            c = in_channels
            for _ in range(num_conv - 1):
                layers.append(ConvModule(c, head_conv, 1, bias=True,
                                         conv_dim=1))
                c = head_conv
            layers.append(Conv1d(c, classes, 1, bias=True))
            if head == 'heatmap':
                nn.init.constant_(layers[-1].bias, init_bias)
            setattr(self, head, nn.Sequential(*layers))

    def forward(self, x):
        """x [B, P, C] -> dict of [B, P, out_ch]."""
        out = {}
        for head in self.heads:
            layers = getattr(self, head)
            y = x
            for cm in layers[:-1]:
                y = F.relu(batch_norm_last(cm.bn, pointwise(cm.conv, y)))
            out[head] = pointwise(layers[-1], y)
        return out


def local_maximum_nms(heatmap, kernel_size: int,
                      flat_classes: Sequence[int] = ()):
    """Keep local maxima of ``heatmap`` [B, C, H, W] (reference :847-859).

    The pooled map fills only the interior of a zero canvas, so border
    cells survive only where they equal 0 (as the JAX package's VALID
    ``reduce_window``); the ``flat_classes`` use kernel 1 (every cell its
    own maximum).
    """
    if kernel_size <= 1:
        return heatmap
    pad = kernel_size // 2
    local_max = torch.zeros_like(heatmap)
    if min(heatmap.shape[-2:]) >= kernel_size:     # else no interior
        local_max[:, :, pad:-pad, pad:-pad] = F.max_pool2d(
            heatmap, kernel_size, stride=1, padding=0)
    if flat_classes:
        cls = list(flat_classes)
        local_max[:, cls] = heatmap[:, cls]
    return torch.where(heatmap == local_max, heatmap, 0.0)


def topk_lower_index_first(x, k: int):
    """Top ``k`` of the last axis, ties broken by the lower index first
    (``jax.lax.top_k``'s order; ``torch.topk`` promises no tie order)."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def upcast(preds):
    """The predictions with bf16 ones in fp32: the decode, the targets and
    the losses run in fp32 (JAX ``transfusion_head.py:539-541,659-661``)."""
    return {k: v.float() if torch.is_tensor(v) and v.dtype == torch.bfloat16
            else v for k, v in preds.items()}


@HEADS.register('TransFusionHead')
class TransFusionHead(nn.Module):

    def __init__(self, num_proposals: int = 128, auxiliary: bool = True,
                 in_channels: int = 128 * 3, hidden_channel: int = 128,
                 num_classes: int = 4, num_decoder_layers: int = 3,
                 num_heads: int = 8, nms_kernel_size: int = 1,
                 ffn_channel: int = 256, dropout: float = 0.1,
                 bn_momentum: float = 0.1, activation: str = 'relu',
                 common_heads: Optional[Dict[str, Any]] = None,
                 num_heatmap_convs: int = 2, bbox_coder: Any = None,
                 train_cfg: Any = None, test_cfg: Any = None,
                 loss_cls: Any = None, loss_bbox: Any = None,
                 fuse_img: bool = False, num_views: int = 0,
                 in_channels_img: int = 64, out_size_factor_img: int = 4,
                 **unused):
        super().__init__()
        # the config's loss types and loss_heatmap are not read: the losses
        # are the JAX package's (focal, L1, unweighted gaussian focal)
        del unused
        self.fuse_img = fuse_img
        self.num_views = num_views
        self.out_size_factor_img = out_size_factor_img
        self.num_proposals = num_proposals
        self.num_classes = num_classes
        self.num_decoder_layers = num_decoder_layers
        self.auxiliary = auxiliary
        self.nms_kernel_size = nms_kernel_size
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.loss_cls = dict(loss_cls or {})
        self.loss_bbox = dict(loss_bbox or {})
        self.coder = BBOX_CODERS.build(dict(bbox_coder))
        self.shared_conv = Conv2d(in_channels, hidden_channel, 3,
                                  padding=1, bias=True)
        self.heatmap_head = nn.Sequential(
            ConvModule(hidden_channel, hidden_channel, 3, padding=1,
                       bias=True),
            Conv2d(hidden_channel, num_classes, 3, padding=1, bias=True))
        self.class_encoding = Conv1d(num_classes, hidden_channel, 1)

        def decoder(cross_only=False):
            return TransformerDecoderLayer(hidden_channel, num_heads,
                                           ffn_channel, dropout, activation,
                                           cross_only=cross_only)
        decoders = [decoder() for _ in range(num_decoder_layers)]
        heads = {k: tuple(v) for k, v in (common_heads or {}).items()}
        heads['heatmap'] = (num_classes, num_heatmap_convs)
        pred_heads = [FFN(hidden_channel, heads)
                      for _ in range(num_decoder_layers)]
        if fuse_img:
            # the reference's image-fusion modules (JAX :238-263)
            self.shared_conv_img = Conv2d(in_channels_img, hidden_channel,
                                          3, padding=1, bias=True)
            self.heatmap_head_img = nn.Sequential(
                ConvModule(hidden_channel, hidden_channel, 3, padding=1,
                           bias=True),
                Conv2d(hidden_channel, num_classes, 3, padding=1, bias=True))
            self.fc = nn.Sequential(Conv1d(hidden_channel, hidden_channel, 1))
            decoders.append(decoder())                      # fusion
            decoders += [decoder(cross_only=True)           # image-to-BEV
                         for _ in range(num_views)]
            pred_heads.append(FFN(2 * hidden_channel, heads))
        self.decoder = nn.ModuleList(decoders)
        self.prediction_heads = nn.ModuleList(pred_heads)

    def _flat_classes(self) -> Tuple[int, ...]:
        dataset = (self.test_cfg or {}).get('dataset')
        return {'nuScenes': (8, 9), 'Waymo': (1, 2)}.get(dataset, ())

    def forward(self, inputs, img_inputs=None, metas=None, generator=None):
        """inputs [B, C_in, H, W] BEV -> dict of [B, C, P * layers]
        predictions, 'dense_heatmap' [B, C, H, W], 'query_heatmap_score'
        [B, C, P], 'query_labels' [B, P] and 'query_spatial' [B, P] (the
        BEV cell index ``y * W + x`` of each proposal). With ``fuse_img``,
        ``img_inputs`` [B, V, C_img, h, w] (the image features of the
        ``num_views`` views) and ``metas`` dict(lidar2img [B, V, 4, 4],
        optional img_scale_factor [B, 2]): the fused layer's predictions
        alone, 'dense_heatmap' the image-fused map and 'on_the_image'
        [B, P] (JAX ``:353-374``). ``generator``: the source of the dropout
        masks in training mode."""
        b, _, h, w = inputs.shape
        nl = self.num_decoder_layers
        lidar_feat = self.shared_conv(inputs)                 # [B, hid, H, W]
        lidar_flat = lidar_feat.flatten(2).transpose(1, 2)    # [B, HW, hid]
        bev_pos = self._bev_pos(h, w, inputs).expand(b, -1, -1)
        fused = self.fuse_img and img_inputs is not None
        if fused:
            with section('img_bev'):
                img_feat, bev_img = self._image_to_bev(
                    img_inputs, lidar_flat, bev_pos, generator)

        dense_heatmap = self.heatmap_head(lidar_feat)         # [B, C, H, W]
        heatmap = torch.sigmoid(dense_heatmap.detach())
        if fused:
            # the image-fused heatmap replaces the LiDAR one in the output;
            # the queries start from the mean of the two (JAX :311-318)
            dense_heatmap = self.heatmap_head_img(
                bev_img.transpose(1, 2).reshape(b, -1, h, w))
            heatmap = (heatmap + torch.sigmoid(dense_heatmap.detach())) / 2.0
        heatmap = local_maximum_nms(heatmap, self.nms_kernel_size,
                                    self._flat_classes())
        heatmap = heatmap.reshape(b, self.num_classes, h * w)
        _, top_idx = topk_lower_index_first(heatmap.reshape(b, -1),
                                            self.num_proposals)
        top_classes = top_idx // (h * w)
        top_spatial = top_idx % (h * w)

        index = top_spatial[:, :, None]
        query_feat = torch.gather(
            lidar_flat, 1, index.expand(-1, -1, lidar_flat.shape[-1]))
        one_hot = F.one_hot(top_classes, self.num_classes).to(inputs.dtype)
        query_feat = query_feat + pointwise(self.class_encoding, one_hot)
        query_pos = torch.gather(bev_pos, 1, index.expand(-1, -1, 2))

        ret_layers = []
        # the LiDAR decoder layers only: with fuse_img the lists go on with
        # the fusion and image-to-BEV decoders and the fused FFN
        for decoder, pred_head in zip(self.decoder[:nl],
                                      self.prediction_heads[:nl]):
            query_feat = decoder(query_feat, lidar_flat, query_pos, bev_pos,
                                 generator=generator)
            res = pred_head(query_feat)
            res['center'] = res['center'] + query_pos
            query_pos = res['center'].detach()
            ret_layers.append(res)
        if fused:
            with section('img_fusion'):
                res, on_any = self._image_refinement(
                    query_feat, query_pos, ret_layers[-1], img_feat, metas,
                    generator)
            ret_layers = [res]

        out = {key: torch.cat([r[key].transpose(1, 2) for r in ret_layers],
                              dim=-1)
               for key in ret_layers[0]}
        if fused:
            out['on_the_image'] = on_any
        out['dense_heatmap'] = dense_heatmap
        out['query_heatmap_score'] = torch.gather(
            heatmap, 2, top_spatial[:, None, :].expand(
                -1, self.num_classes, -1))
        out['query_labels'] = top_classes
        out['query_spatial'] = top_spatial
        return out

    @staticmethod
    def _bev_pos(h: int, w: int, like):
        """[1, H * W, 2] cell centres (x + 0.5, y + 0.5), row-major (the
        reference's create_2D_grid)."""
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=like.dtype, device=like.device) + 0.5,
            torch.arange(w, dtype=like.dtype, device=like.device) + 0.5,
            indexing='ij')
        return torch.stack([xs, ys], dim=-1).reshape(1, h * w, 2)

    def _image_to_bev(self, img_inputs, lidar_flat, bev_pos, generator):
        """(image features [B, V, hid, h, w], the BEV features [B, HW, hid]
        after a cross-attention to each view's height-collapsed columns in
        turn) (JAX :283-303)."""
        b, v, _, ih, iw = img_inputs.shape
        if v != self.num_views:
            raise ValueError(f'{v} image views, the head has '
                             f'{self.num_views}')
        nl = self.num_decoder_layers
        # off cuDNN: see layers.cudnn_enabled
        with cudnn_enabled(False):
            img_feat = self.shared_conv_img(img_inputs.flatten(0, 1))
        img_feat = img_feat.reshape(b, v, -1, ih, iw)
        collapsed = img_feat.max(dim=3).values.transpose(2, 3)  # [B,V,w,hid]
        collapsed = pointwise(self.fc[0], collapsed)
        col_x = torch.arange(iw, dtype=img_feat.dtype,
                             device=img_feat.device)
        bev_feat = lidar_flat
        for vi in range(v):
            col_pos = torch.stack([col_x + vi * iw + 0.5,
                                   torch.full_like(col_x, 0.5)], -1)
            bev_feat = self.decoder[nl + 1 + vi](
                bev_feat, collapsed[:, vi], bev_pos,
                col_pos.expand(b, -1, -1), generator=generator)
        return img_feat, bev_feat

    def _image_refinement(self, query_feat, query_pos, last, img_feat,
                          metas, generator):
        """The proposals refined by the image features of the views they
        project onto (JAX :377-463): (the fused predictions, each [B, P, *],
        the LiDAR layer's ``last`` where a proposal is on no image;
        on_the_image [B, P]). The proposal's centre (its query position
        and the predicted height) and its decoded box's corners are
        projected through ``lidar2img``; the centre is on a view's image
        where it lies strictly inside the padded image; the fusion
        decoder's attention to that view's features takes the log of a
        gaussian around the centre's feature cell (truncated toward zero)
        with a sigma from the corners' extent. Views run one at a time; a
        later view overwrites an earlier one's refinement."""
        tc = self.test_cfg
        b, v, hid, ih, iw = img_feat.shape
        nl = self.num_decoder_layers
        osf = self.out_size_factor_img
        prev_query = query_feat.detach()
        vel = last.get('vel')
        dec = self.coder.decode(*(last[k].detach().transpose(1, 2) for k in (
            'heatmap', 'rot', 'dim', 'center', 'height')),
            None if vel is None else vel.detach().transpose(1, 2))
        corners = corners_3d(dec['bboxes'][..., :7])          # [B, P, 8, 3]
        centers = torch.stack([
            query_pos[..., 0] * tc['out_size_factor'] * tc['voxel_size'][0]
            + tc['pc_range'][0],
            query_pos[..., 1] * tc['out_size_factor'] * tc['voxel_size'][1]
            + tc['pc_range'][1],
            last['height'][..., 0]], -1)
        pts = torch.cat([centers[:, :, None, :], corners], 2)  # [B, P, 9, 3]
        hom = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
        proj = torch.einsum('bvij,bpkj->bvpki', metas['lidar2img'].to(
            hom.dtype), hom)                                  # [B,V,P,9,4]
        uv = proj[..., :2] / torch.clamp(proj[..., 2:3], min=1e-5)
        scale = metas.get('img_scale_factor')
        if scale is not None:
            uv = uv * scale.to(uv.dtype)[:, None, None, None, :]
        ctr_uv = uv[:, :, :, 0, :]                            # [B, V, P, 2]
        on_image = ((ctr_uv[..., 0] > 0) & (ctr_uv[..., 0] < iw * osf)
                    & (ctr_uv[..., 1] > 0) & (ctr_uv[..., 1] < ih * osf))
        corner_uv = uv[:, :, :, 1:, :] / osf
        extent = corner_uv.amax(3) - corner_uv.amin(3)        # [B, V, P, 2]
        radius = torch.ceil(torch.linalg.vector_norm(extent, dim=-1) / 2.0)
        sigma = (radius * 2 + 1) / 6.0                        # [B, V, P]
        centers_feat = ctr_uv / osf
        cells = centers_feat.detach().to(torch.int32).to(ctr_uv.dtype)
        feat_pos = self._bev_pos(ih, iw, img_feat)            # [1, hw, 2]
        grid = feat_pos[0] - 0.5

        new_query = prev_query
        assigned = torch.full((b, self.num_proposals), -1, dtype=torch.int64,
                              device=query_feat.device)
        for vi in range(v):
            # the gaussian mask of this view alone ([B, P, h * w])
            d2 = ((cells[:, vi, :, None, :] - grid) ** 2).sum(-1)
            gauss = torch.exp(-d2 / (2 * sigma[:, vi, :, None] ** 2))
            mask = torch.log(torch.clamp(gauss, min=1e-30))
            refined = self.decoder[nl](
                prev_query, img_feat[:, vi].flatten(2).transpose(1, 2),
                centers_feat[:, vi], feat_pos.expand(b, -1, -1),
                attn_mask=mask[:, None], generator=generator)
            sel = on_image[:, vi]
            new_query = torch.where(sel[..., None], refined, new_query)
            assigned = torch.where(sel, vi, assigned)
        on_any = assigned >= 0
        res = self.prediction_heads[nl](torch.cat([new_query, prev_query],
                                                  -1))
        res['center'] = res['center'] + query_pos
        return ({k: torch.where(on_any[..., None], x, last[k])
                 for k, x in res.items()}, on_any)

    # ------------------------------------------------------------------
    # loss and targets
    # ------------------------------------------------------------------
    def loss(self, preds, gt_bboxes, gt_labels, gt_valid, targets=None):
        """Training losses (reference :1220-1286) of ``forward``'s
        ``preds`` against padded ground truth: gt_bboxes [B, G, 9]
        bottom-centre boxes with velocity (or [B, G, 7] where the coder's
        code size is 8), gt_labels [B, G], gt_valid [B, G]. With
        'on_the_image' in ``preds`` the classification and box terms count
        the proposals on an image only. ``targets``: a ``get_targets``
        result to use instead of assigning anew (so that two paths can
        share one assignment).
        Returns {'loss_heatmap', 'layer_-1_loss_cls', 'layer_-1_loss_bbox'
        (``layer_{i}`` for auxiliary layers), 'matched_ious'}."""
        p = self.num_proposals
        num_layers = self.num_decoder_layers if self.auxiliary else 1
        preds = upcast(preds)
        if targets is None:
            targets = self.get_targets(preds, gt_bboxes, gt_labels, gt_valid)
        (labels, label_weights, bbox_targets, bbox_weights, num_pos,
         matched_ious, heatmap_tgt) = targets
        if 'on_the_image' in preds:
            # image fusion: only the proposals on an image are supervised
            # (JAX :485-491, reference :1237-1240)
            on = preds['on_the_image'].to(label_weights.dtype)
            label_weights = label_weights * on
            bbox_weights = bbox_weights * on[..., None]
            num_pos = bbox_weights.amax(-1).sum()
        # the normalisers are the global batch's: inside a process group
        # each rank's terms are its share of the global loss, which the
        # ranks' sum gives (JAX's are global under GSPMD)
        num_pos, hm_peaks = all_sum(torch.stack([
            num_pos.to(torch.float32),
            (heatmap_tgt == 1.0).sum().to(torch.float32)]))
        losses = {}
        clipped = clip_sigmoid(preds['dense_heatmap'])
        hm_avg = torch.clamp(hm_peaks, min=1)
        losses['loss_heatmap'] = \
            gaussian_focal_loss(clipped, heatmap_tgt).sum() / hm_avg
        code_weights = preds['heatmap'].new_tensor(
            self.train_cfg['code_weights'])
        avg = torch.clamp(num_pos, min=1)
        for idx in range(num_layers):
            prefix = 'layer_-1' if idx == num_layers - 1 else f'layer_{idx}'
            sl = slice(idx * p, (idx + 1) * p)
            cls_score = preds['heatmap'][..., sl].transpose(1, 2).reshape(
                -1, self.num_classes)
            loss_cls = sigmoid_focal_loss(
                cls_score, labels[..., sl].reshape(-1), self.num_classes,
                gamma=self.loss_cls.get('gamma', 2.0),
                alpha=self.loss_cls.get('alpha', 0.25))
            # [N] losses times [N, 1] weights: the JAX package's broadcast,
            # which sums the outer product, i.e. N times the reference's
            # weighted sum when every weight is 1 (ROADMAP section 3); the
            # weights are the global batch's (gather_rows), so the ranks'
            # shares sum to the global batch's outer product
            lw = gather_rows(label_weights[..., sl]).reshape(-1)
            loss_cls = (loss_cls * lw[:, None]).sum() / avg
            losses[f'{prefix}_loss_cls'] = \
                loss_cls * self.loss_cls.get('loss_weight', 1.0)
            parts = [preds[k][..., sl] for k in ('center', 'height', 'dim',
                                                 'rot', 'vel') if k in preds]
            pred_box = torch.cat(parts, 1).transpose(1, 2)
            reg_w = bbox_weights[:, sl, :] * code_weights
            loss_bbox = (l1_loss(pred_box, bbox_targets[:, sl, :])
                         * reg_w).sum() / avg
            losses[f'{prefix}_loss_bbox'] = \
                loss_bbox * self.loss_bbox.get('loss_weight', 1.0)
        losses['matched_ious'] = matched_ious
        return losses

    @torch.no_grad()
    def get_targets(self, preds, gt_bboxes, gt_labels, gt_valid):
        """Hungarian assignment and target tensors (reference
        :1092-1218): (labels [B, P*L], label_weights, bbox_targets
        [B, P*L, code], bbox_weights, num_pos, matched_ious, heatmap
        targets [B, C, H, W])."""
        tc = self.train_cfg
        p = self.num_proposals
        num_layers = self.num_decoder_layers if self.auxiliary else 1
        preds = upcast(preds)
        score = preds['heatmap'].detach()
        vel = preds.get('vel')
        pred_boxes = self.coder.decode(
            score, preds['rot'].detach(), preds['dim'].detach(),
            preds['center'].detach(), preds['height'].detach(),
            None if vel is None else vel.detach())['bboxes']
        parts = [self._hungarian_assign(pred_boxes[:, idx * p:(idx + 1) * p],
                                        score[..., idx * p:(idx + 1) * p],
                                        gt_bboxes, gt_labels, gt_valid)
                 for idx in range(num_layers)]
        assigned = torch.cat([a for a, _ in parts], 1)
        max_iou = torch.cat([m for _, m in parts], 1)

        pos = assigned >= 0
        safe = torch.clamp(assigned, min=0).to(torch.int64)
        gt_for = torch.gather(
            gt_bboxes, 1, safe[..., None].expand(-1, -1, gt_bboxes.shape[-1]))
        enc = self.coder.encode(gt_for)
        bbox_targets = torch.where(pos[..., None], enc, 0.0)
        bbox_weights = pos[..., None].expand_as(enc).to(enc.dtype)
        labels = torch.where(pos, torch.gather(gt_labels.to(torch.int64), 1,
                                               safe), self.num_classes)
        label_weights = torch.ones_like(labels, dtype=enc.dtype)
        num_pos = pos.sum()
        # this rank's share of the global mean (the ranks' sum)
        matched_ious = torch.where(pos, max_iou, 0.0).sum() / \
            torch.clamp(all_sum(num_pos), min=1)

        # dense heatmap targets
        fm_h, fm_w = self._bev_shape()
        vx = tc['voxel_size'][0] * tc['out_size_factor']
        vy = tc['voxel_size'][1] * tc['out_size_factor']
        x0, y0 = tc['point_cloud_range'][0], tc['point_cloud_range'][1]
        heatmaps = []
        for boxes, labels_s, valid_s in zip(gt_bboxes, gt_labels, gt_valid):
            width = boxes[:, 3] / vx
            length = boxes[:, 4] / vy
            radius = gaussian_radius((length, width), tc['gaussian_overlap'])
            radius = torch.clamp(radius.to(torch.int32),
                                 min=tc['min_radius']).to(torch.float32)
            cx = ((boxes[:, 0] - x0) / vx).to(torch.int32)
            cy = ((boxes[:, 1] - y0) / vy).to(torch.int32)
            ok = valid_s & (boxes[:, 3] > 0) & (boxes[:, 4] > 0)
            heatmaps.append(draw_heatmap(torch.stack([cx, cy], -1), radius,
                                         labels_s, ok, self.num_classes,
                                         (fm_h, fm_w)))
        return (labels, label_weights, bbox_targets, bbox_weights, num_pos,
                matched_ious, torch.stack(heatmaps))

    def _bev_shape(self) -> Tuple[int, int]:
        """(H, W) of the BEV feature map: the grid over the output stride."""
        grid, osf = self.test_cfg['grid_size'], self.test_cfg['out_size_factor']
        return grid[1] // osf, grid[0] // osf

    def _hungarian_assign(self, pred_boxes, cls_score, gt_bboxes, gt_labels,
                          gt_valid):
        """Batched Hungarian assignment (HungarianAssigner3D,
        mmdet3d/core/bbox/assigners/hungarian_assigner.py:96-153) with the
        auction: (assigned ground truth [B, P] int32, -1 = background;
        the IoU with it [B, P])."""
        acfg = self.train_cfg['assigner']
        b, p = pred_boxes.shape[:2]
        g = gt_bboxes.shape[1]
        prob = torch.sigmoid(cls_score).transpose(1, 2)          # [B, P, C]
        eps = 1e-12
        gamma = acfg['cls_cost'].get('gamma', 2.0)
        alpha = acfg['cls_cost'].get('alpha', 0.25)
        neg_cost = -torch.log(1 - prob + eps) * (1 - alpha) * prob ** gamma
        pos_cost = -torch.log(prob + eps) * alpha * (1 - prob) ** gamma
        lab = torch.clamp(gt_labels, min=0).to(torch.int64)[:, None, :] \
            .expand(b, p, g)
        cls_cost = (torch.gather(pos_cost, 2, lab)
                    - torch.gather(neg_cost, 2, lab)) \
            * acfg['cls_cost'].get('weight', 1.0)

        pcr = self.train_cfg['point_cloud_range']
        span = pred_boxes.new_tensor([pcr[3] - pcr[0], pcr[4] - pcr[1]])
        start = pred_boxes.new_tensor(pcr[:2])
        pxy = (pred_boxes[..., :2] - start) / span
        gxy = (gt_bboxes[..., :2] - start) / span
        reg_cost = (pxy[:, :, None, :] - gxy[:, None, :, :]).abs().sum(-1) \
            * acfg['reg_cost'].get('weight', 1.0)

        iou = torch.stack([boxes_iou_3d(a[:, :7], bb[:, :7])
                           for a, bb in zip(pred_boxes, gt_bboxes)])
        cost = cls_cost + reg_cost - iou * acfg['iou_cost'].get('weight', 1.0)
        cost = torch.where(gt_valid[:, None, :], cost, 1e8)
        assigned = torch.stack([assign_proposals(c, v)
                                for c, v in zip(cost, gt_valid)])
        safe = torch.clamp(assigned, min=0).to(torch.int64)
        max_iou = torch.where(assigned >= 0,
                              torch.gather(iou, 2, safe[..., None])[..., 0],
                              0.0)
        return assigned, max_iou

    def get_bboxes(self, preds):
        """Decode the last layer's proposals (reference :1288-1379) into
        fixed-size [B, P] 'bboxes'/'scores'/'labels'/'valid' (no NMS: the
        configuration's ``nms_type`` is None), in fp32 whatever the
        predictions' dtype."""
        p = self.num_proposals
        preds = upcast(preds)
        score = torch.sigmoid(preds['heatmap'][..., -p:])
        one_hot = F.one_hot(preds['query_labels'], self.num_classes)
        score = score * preds['query_heatmap_score'] * \
            one_hot.transpose(1, 2).to(score.dtype)
        vel = preds.get('vel')
        return self.coder.decode(
            score, preds['rot'][..., -p:], preds['dim'][..., -p:],
            preds['center'][..., -p:], preds['height'][..., -p:],
            None if vel is None else vel[..., -p:], filter=True)
