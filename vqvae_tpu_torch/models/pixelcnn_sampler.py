"""Cached autoregressive decoding for GatedPixelCNN (port of
``vqvae_tpu/models/pixelcnn_sampler.py``).

The reference samples with one full forward over the whole grid per pixel.
This decoder uses the model's causal structure instead:

- **Row cache.** Every layer's vertical-stack features for row i depend only
  on rows < i, so one vertical-only pass per row gives each layer's vertical
  features for that row. ``row_refresh="full"`` recomputes the whole grid
  (the JAX package's choice for small grids); ``"band"`` recomputes only the
  rows that row i can see through the stack; ``"auto"`` takes the band when
  it is smaller than the grid (H > ``band_pad`` + 1; 18 rows for 15 layers,
  so the 8 x 8 latent grids take ``"full"``).
- **Column cache.** The horizontal stack at (i, j) needs the last k//2
  columns of each layer's horizontal input in the current row and the cached
  vertical feature at (i, j): per pixel, a chain of small (B, .) x (., 2d)
  matmuls bottom-up through the layers.

With ``force_grid`` it runs teacher-forced and returns the logits of every
pixel, which the tests hold against the full forward.

It always computes in fp32, whatever ``compute_dtype`` says (the JAX note at
pixelcnn_sampler.py:68-72), with the matmuls and convs under the config's
``conv_precision`` (``highest``: no TF32). The weights are arranged once, at
construction: masked kernels, matmul layouts, and the constant biases of the
horizontal pre-activation summed. Layouts of the work: the vertical refresh
runs NCHW through cuDNN; the horizontal inputs of a row live in one buffer
of shape (L, B, W + 3, d) (columns left of the row are zeros), so the window
of a pixel is a strided view, with no copy, that goes straight into
``addmm``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from vqvae_tpu_torch.models.pixelcnn import GatedPixelCNN, draw_codes, gate, layer_geometry
from vqvae_tpu_torch.ops.conv import conv2d, conv_fp32_precision


class CachedPixelCNNSampler:
    """Incremental decoder bound to a ``GatedPixelCNN``'s weights (a snapshot
    taken at construction, on the model's device)."""

    def __init__(self, model: GatedPixelCNN, row_refresh: str = "auto"):
        if row_refresh not in ("auto", "full", "band"):
            raise ValueError(f"row_refresh={row_refresh!r}")
        self.cfg = cfg = model.config
        self.row_refresh = row_refresh
        self.device = model.embedding.device
        # vertical reach of each layer and what the layers above add to it:
        # layer l's row i needs rows [i - suffix[l], i] of its own output
        self._reaches = [layer_geometry(l)[1] // 2 for l in range(cfg.n_layers)]
        suffix = [0] * cfg.n_layers
        for l in range(cfg.n_layers - 2, -1, -1):
            suffix[l] = suffix[l + 1] + self._reaches[l + 1]
        self.band_pad = suffix[0] + self._reaches[0]
        self._pad = max(self._reaches)  # zero columns left of a row in the column buffer

        def f32(t):  # a copy: later updates of the model's weights do not reach it
            return t.detach().to(torch.float32, copy=True).contiguous()

        with torch.no_grad():
            self._embedding = f32(model.embedding)
            self._vert, self._cls, self._horiz, self._v2h, self._resid = [], [], [], [], []
            for layer in model.layers():
                w_vert, w_horiz = layer.masked_kernels()
                self._vert.append((f32(w_vert), f32(layer.vert_stack_b)))
                self._cls.append(f32(layer.class_cond_embedding))
                # (2d, d, 1, k//2+1) -> (window of (k//2+1) columns x d, 2d)
                self._horiz.append(f32(w_horiz[:, :, 0].permute(2, 1, 0).reshape(-1, w_horiz.shape[0])))
                self._v2h.append((f32(layer.vert_to_horiz_w[:, :, 0, 0].T),
                                  f32(layer.vert_to_horiz_b + layer.horiz_stack_b)))
                self._resid.append((f32(layer.horiz_resid_w[:, :, 0, 0].T), f32(layer.horiz_resid_b)))
            self._out1 = (f32(model.out1_w[:, :, 0, 0].T), f32(model.out1_b))
            self._out2 = (f32(model.out2_w[:, :, 0, 0].T), f32(model.out2_b))

    def _use_band(self, hgt: int) -> bool:
        if self.row_refresh == "auto":
            return hgt > self.band_pad + 1
        return self.row_refresh == "band"

    # -- row refresh: vertical features of one row --------------------------

    def _row_refresh(self, emb: torch.Tensor, cls: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every layer's vertical pre-activation over the whole grid,
        (B, 2d, H, W) each. emb: (B, d, H, W) embedded grid; row i of the
        result depends only on rows < i of ``emb``."""
        x_v, hgt, hv_all = emb, emb.shape[2], []
        for l, (w, b) in enumerate(self._vert):
            k = layer_geometry(l)[1]
            hv = conv2d(x_v, w, b, padding=(k // 2, k // 2), precision=self.cfg.conv_precision)[:, :, :hgt]
            hv_all.append(hv)
            x_v = gate(hv + cls[l])
        return hv_all

    def _row_refresh_band(self, emb: torch.Tensor, cls: List[torch.Tensor], i: int) -> List[torch.Tensor]:
        """Every layer's vertical pre-activation at row ``i`` only, (B, 2d, 1, W)
        each, through depth-limited bands: layer 0 reads the ``band_pad`` + 1
        embedding rows that end at row i (zeros above the grid top, as the
        full conv's padding), and each conv, valid in height, trims its own
        reach off the top."""
        lo = i - self.band_pad
        x_v = emb[:, :, max(lo, 0): i + 1]
        if lo < 0:
            x_v = F.pad(x_v, (0, 0, -lo, 0))
        hv_rows = []
        for l, (w, b) in enumerate(self._vert):
            k = layer_geometry(l)[1]
            hv = conv2d(x_v, w, b, padding=(0, k // 2), precision=self.cfg.conv_precision)
            hv_rows.append(hv[:, :, -1:])
            x_v = gate(hv + cls[l])
            # band rows above the grid top must be zeros, as the full conv's
            # padding is: gate(bias + cls) of a padded row is not
            above = x_v.shape[2] - 1 - i
            if above > 0:
                x_v[:, :, :above] = 0.0
        return hv_rows

    # -- per-pixel horizontal step -------------------------------------------

    def _pixel_step(self, bufs: torch.Tensor, v2h_row: List[torch.Tensor], j: int) -> torch.Tensor:
        """Advance the horizontal stacks one pixel, bottom-up; -> (B, K) logits.

        bufs: (L, B, W + pad, d), layer l's horizontal inputs of the current
        row at columns pad + j'. Layer 0's column j holds the forced code's
        embedding, or zeros while sampling: mask A never reads it. The step
        writes each layer's output at column j into the next layer's buffer.
        v2h_row: per layer (B, W, 2d), the row's vertical-to-horizontal
        projection plus the constant biases and the class bias.
        """
        pad = self._pad
        for l, wh in enumerate(self._horiz):
            _mask, k, residual = layer_geometry(l)
            window = bufs[l, :, pad + j - k // 2: pad + j + 1].flatten(1)  # (B, (k//2+1) d), a view
            pre = torch.addmm(v2h_row[l][:, j], window, wh)
            out = gate(pre, dim=1)
            w_res, b_res = self._resid[l]
            cur = bufs[l, :, pad + j]
            out_h = torch.addmm(b_res, out, w_res)
            if residual:
                out_h += cur
            if l + 1 < len(self._horiz):
                bufs[l + 1, :, pad + j] = out_h
        w1, b1 = self._out1
        w2, b2 = self._out2
        hidden = torch.addmm(b1, out_h, w1).relu_()
        return torch.addmm(b2, hidden, w2)

    # -- public API ------------------------------------------------------------

    @torch.no_grad()
    def generate(
        self,
        label: torch.Tensor,
        generator: Optional[torch.Generator],
        shape: Tuple[int, int] = (8, 8),
        batch_size: int = 64,
        force_grid: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Sample (B, H, W) int32 code grids, one (B, K) draw per pixel in
        raster order from ``generator`` (``draw_codes``); with ``force_grid``
        run teacher-forced and return the (B, H, W, K) fp32 logits instead."""
        cfg, dev = self.cfg, self.device
        hgt, wid = shape
        label = torch.as_tensor(label, device=dev).long()
        teacher = force_grid is not None
        if teacher:
            x = torch.as_tensor(force_grid, device=dev).long().clone()
            batch_size = x.shape[0]
            logits_all = torch.empty((batch_size, hgt, wid, cfg.input_dim), device=dev)
        else:
            x = torch.zeros((batch_size, hgt, wid), dtype=torch.long, device=dev)
        if x.shape != (batch_size, hgt, wid) or label.shape != (batch_size,):
            raise ValueError(f"grid {tuple(x.shape)} and labels {tuple(label.shape)} do not "
                             f"match batch {batch_size} and shape {shape}")
        use_band = self._use_band(hgt)
        pad = self._pad
        with conv_fp32_precision(cfg.conv_precision):
            cls = [c[label][:, :, None, None] for c in self._cls]  # (B, 2d, 1, 1) each
            const = [b[None, None, :] + c[label][:, None, :] for (_w, b), c in zip(self._v2h, self._cls)]
            bufs = torch.empty((cfg.n_layers, batch_size, wid + pad, cfg.dim), device=dev)
            for i in range(hgt):
                # rows >= i of the embedded grid are never read for row i
                emb = F.embedding(x, self._embedding).permute(0, 3, 1, 2)
                if use_band:
                    hv_rows = [hv[:, :, 0] for hv in self._row_refresh_band(emb, cls, i)]
                else:
                    hv_rows = [hv[:, :, i] for hv in self._row_refresh(emb, cls)]
                v2h_row = [torch.matmul(hv.transpose(1, 2), w) + c
                           for hv, (w, _b), c in zip(hv_rows, self._v2h, const)]  # (B, W, 2d)
                bufs.zero_()
                if teacher:
                    bufs[0, :, pad:] = emb[:, :, i].transpose(1, 2)
                for j in range(wid):
                    logits = self._pixel_step(bufs, v2h_row, j)
                    if teacher:
                        logits_all[:, i, j] = logits
                    else:
                        code = draw_codes(logits, generator)
                        x[:, i, j] = code
                        bufs[0, :, pad + j] = self._embedding[code]
        if teacher:
            return logits_all
        return x.to(torch.int32)


__all__ = ["CachedPixelCNNSampler"]
