"""Latent diffusion denoiser: FiLM-gated MLP U-Net over z-vectors.

Counterpart of `damc_tpu/models/denoiser.py`. Topology (nf=4):
  input_emb: random-Fourier features with learnable B (nz, nz/2):
             [sin(2 pi z B), cos(2 pi z B), z] -> 2 nz
  in:   CSL(2nz -> 32nf) -> CSL(32nf -> 64nf) -> CSL(64nf -> 64nf)
  mid:  CSL(64nf -> 64nf)
  out:  skip-concat U-Net tail back down to nz
  ctx:  [time_mlp(arctan-warped logsnr), xemb]

Sampling path: the context is [temb(step), xemb], and SiLU acts elementwise,
so every CSL's context product splits exactly:
    SiLU([t, x]) @ [Kt; Kx] + b == SiLU(t) @ Kt + b + SiLU(x) @ Kx.
`sample_tables` computes the step half for all steps and the sample half
once; the reverse-sweep kernel reads those tables.

Module names keep the reference torch key layout (`B`, `time_mlp.1`,
`in_layers.0._layer_ctx.1`, `._hyper_gate`, `._hyper_bias`, `._layer.0`,
`._skip`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class SinusoidalTimeEmbedding(nn.Module):
    """sin/cos embedding of a time in [0, 1] (scaled by 1000 inside)."""

    def __init__(self, dim: int, max_time: float = 1.0):
        super().__init__()
        self.dim = dim
        self.max_time = max_time

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t * (1000.0 / self.max_time)
        half = self.dim // 2
        freqs = torch.exp(
            torch.arange(half, dtype=torch.float32, device=t.device)
            * (-math.log(10000.0) / (half - 1))
        )
        args = t[:, None].to(torch.float32) * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class ConcatSquashLinear(nn.Module):
    """out = Lin(x) * sigmoid(gate(c)) + bias(c) + skip(x),
    c = SiLU(CtxLin(SiLU(ctx)))."""

    def __init__(self, dim_in: int, dim_out: int, nctx: int):
        super().__init__()
        self.dim_in = dim_in
        self.dim_out = dim_out
        self._layer_ctx = nn.Sequential(nn.SiLU(), nn.Linear(nctx, dim_out))
        self._hyper_gate = nn.Linear(dim_out, dim_out)
        self._hyper_bias = nn.Linear(dim_out, dim_out, bias=False)
        self._layer = nn.Sequential(nn.Linear(dim_in, dim_out))
        self._skip = nn.Linear(dim_in, dim_out)

    @property
    def ctx_linear(self) -> nn.Linear:
        return self._layer_ctx[1]

    def forward(self, ctx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        gate, bias = self.film_from_pre(self._layer_ctx(ctx))
        return self.apply_x(x, gate, bias)

    def ctx_pre_split(
        self, temb: torch.Tensor, xemb: torch.Tensor, ntemb: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(SiLU(temb) @ Kt + bias, SiLU(xemb) @ Kx)."""
        w = self.ctx_linear.weight  # (dout, ntemb + nxemb)
        pre_t = F.silu(temb) @ w[:, :ntemb].t() + self.ctx_linear.bias
        pre_x = F.silu(xemb) @ w[:, ntemb:].t()
        return pre_t, pre_x

    def film_from_pre(self, pre: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c = F.silu(pre)
        return torch.sigmoid(self._hyper_gate(c)), self._hyper_bias(c)

    def apply_x(self, x: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.dim_in:
            raise ValueError(f"expected width {self.dim_in}, got {tuple(x.shape)}")
        return self._layer(x) * gate + bias + self._skip(x)


class LatentDenoiser(nn.Module):
    """eps-predictor p(z_t, logsnr, xemb) -> eps_hat (B, nz).

    `widths` overrides the nf-derived (narrow, wide) = (32 nf, 64 nf)."""

    def __init__(
        self,
        nz: int,
        nxemb: int,
        ntemb: int,
        nf: int = 4,
        residual: bool = False,
        widths: Optional[Tuple[int, int]] = None,
    ):
        super().__init__()
        narrow, wide = widths or (32 * nf, 64 * nf)
        self.nz, self.nxemb, self.ntemb = nz, nxemb, ntemb
        self.residual = residual
        nctx = ntemb + nxemb
        self.time_mlp = nn.Sequential(
            SinusoidalTimeEmbedding(ntemb),
            nn.Linear(ntemb, ntemb),
            nn.SiLU(),
            nn.Linear(ntemb, ntemb),
        )
        self.B = nn.Parameter(torch.empty(nz, nz // 2))
        self.in_layers = nn.ModuleList(
            [
                ConcatSquashLinear(2 * nz, narrow, nctx),
                ConcatSquashLinear(narrow, wide, nctx),
                ConcatSquashLinear(wide, wide, nctx),
            ]
        )
        self.mid_layers = nn.ModuleList([ConcatSquashLinear(wide, wide, nctx)])
        self.out_layers = nn.ModuleList(
            [
                ConcatSquashLinear(2 * wide, wide, nctx),
                ConcatSquashLinear(2 * wide, narrow, nctx),
                ConcatSquashLinear(2 * narrow, nz, nctx),
            ]
        )

    @property
    def all_layers(self) -> List[ConcatSquashLinear]:
        return [*self.in_layers, *self.mid_layers, *self.out_layers]

    def time_embed(self, logsnr: torch.Tensor) -> torch.Tensor:
        """arctan-warped logsnr -> temb."""
        t = torch.arctan(
            torch.exp(-0.5 * torch.clamp(logsnr.to(torch.float32), -20.0, 20.0))
        ) / (0.5 * math.pi)
        return self.time_mlp(t)

    def input_emb(self, z: torch.Tensor) -> torch.Tensor:
        proj = 2.0 * math.pi * (z @ self.B)
        return torch.cat([torch.sin(proj), torch.cos(proj), z], dim=-1)

    def _unet(self, z: torch.Tensor, films: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
        act = lambda h: F.leaky_relu(h, 0.01)
        out = self.input_emb(z)
        hs = []
        li = 0
        for layer in self.in_layers:
            out = layer.apply_x(out, *films[li])
            li += 1
            hs.append(out)
            out = act(out)
        for layer in self.mid_layers:
            out = layer.apply_x(out, *films[li])
            li += 1
        for layer in self.out_layers:
            out = act(torch.cat([out, hs.pop()], dim=-1))
            out = layer.apply_x(out, *films[li])
            li += 1
        return z + out if self.residual else out

    def forward(self, z: torch.Tensor, logsnr: torch.Tensor, xemb: Optional[torch.Tensor]):
        temb = self.time_embed(logsnr)
        if xemb is None:
            if self.nxemb != 0:
                raise ValueError(
                    f"xemb=None requires nxemb == 0, but this denoiser has nxemb={self.nxemb}"
                )
            ctx = temb
        else:
            ctx = torch.cat([temb, xemb.to(temb.dtype)], dim=-1)
        films = [l.film_from_pre(l._layer_ctx(ctx)) for l in self.all_layers]
        return self._unet(z, films)

    # ---- hoisted sampling path -------------------------------------------

    def sample_tables(
        self, logsnr_grid: torch.Tensor, xemb: torch.Tensor
    ) -> Dict[str, List[torch.Tensor]]:
        """{'pre_t': [(n, d)...], 'pre_x': [(B, d)...]}, one per layer."""
        temb_grid = self.time_embed(logsnr_grid)
        pre_t, pre_x = [], []
        for layer in self.all_layers:
            t_part, x_part = layer.ctx_pre_split(temb_grid, xemb, self.ntemb)
            pre_t.append(t_part)
            pre_x.append(x_part)
        return {"pre_t": pre_t, "pre_x": pre_x}

    def denoise_from_tables(self, z, pre_t_step, pre_x):
        """One evaluation with this step's rows of the tables: pre_t_step is
        a list of (d,) rows, pre_x a list of (B, d)."""
        films = [
            l.film_from_pre(t[None, :] + x)
            for l, t, x in zip(self.all_layers, pre_t_step, pre_x)
        ]
        return self._unet(z, films)
