"""The port's analytic FLOPs model (`damc_tpu_torch/utils/flops.py`) against
the JAX package's (`damc_tpu/utils/flops.py`): every gen_recon count equal
to rel 1e-12 on every preset, the per-network counts against
`counted_flops` (torch's FlopCounterMode) on single applies at 32x32 within
tests/test_flops_model.py's tolerances (0.15; 0.10 for the EBM), the
inversion counts unchanged, and the peak table."""

from __future__ import annotations

import pytest
import torch

from damc_tpu.utils import flops as jf
from damc_tpu.utils.config import preset as jax_preset
from damc_tpu_torch.config import preset
from damc_tpu_torch.models import DAMCAmortizer, LatentEBM, generator_spec, make_encoder, make_generator
from damc_tpu_torch.utils import flops as pf

PRESETS = ["cifar10", "svhn", "celeba64", "celebaHQ", "mnist_anomaly", "toy"]
B = 8


def _close(got, want):
    assert got == pytest.approx(want, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("batch", [16, 128, 500])
@pytest.mark.parametrize("name", PRESETS)
def test_step_and_phase_counts_match_jax(name, batch):
    got, want = pf.train_step_flops(preset(name), batch), jf.train_step_flops(jax_preset(name), batch)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])
    got, want = pf.sampling_phase_flops(preset(name), batch), jf.sampling_phase_flops(jax_preset(name), batch)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("name", PRESETS)
def test_network_counts_match_jax(name):
    m, n = preset(name).model, preset(name).diffusion.n_interval
    _close(pf.generator_fwd_flops(m.dataset, m.ngf, m.nc, m.nz), jf.generator_fwd_flops(m.dataset, m.ngf, m.nc, m.nz))
    for nc in (m.nc, None):
        _close(pf.encoder_fwd_flops(m.dataset, m.nxemb, m.nif, m.image_size, nc),
               jf.encoder_fwd_flops(m.dataset, m.nxemb, m.nif, m.image_size, nc))
    for widths in (None, (1024, 1024)):
        args = (m.nz, m.nxemb, m.ntemb, m.nf)
        _close(pf.denoiser_fwd_flops(*args, widths), jf.denoiser_fwd_flops(*args, widths))
        _close(pf.denoiser_train_fwd_flops(*args, widths), jf.denoiser_train_fwd_flops(*args, widths))
        for g, w in zip(pf.denoiser_sweep_setup_flops(*args, n, widths), jf.denoiser_sweep_setup_flops(*args, n, widths)):
            _close(g, w)
    _close(pf.ebm_fwd_flops(m.nz, m.ndf), jf.ebm_fwd_flops(m.nz, m.ndf))
    _close(pf.ebm_fwd_flops(m.nz, m.ndf, 3), jf.ebm_fwd_flops(m.nz, m.ndf, 3))
    _close(pf.prior_embed_fwd_flops(m.nz, m.nxemb), jf.prior_embed_fwd_flops(m.nz, m.nxemb))


@pytest.mark.parametrize("h,k,stride,pad", [(1, 8, 1, "VALID"), (4, 4, 2, "SAME"), (8, 3, 1, "SAME"), (7, 4, 2, "SAME")])
def test_layer_counts_match_jax(h, k, stride, pad):
    assert pf.convt_fwd_flops(h, 16, 8, k, stride, pad) == jf.convt_fwd_flops(h, 16, 8, k, stride, pad)
    for padding in ("SAME", "VALID", 1):
        assert pf.conv_fwd_flops(h * 4, h * 4, 3, 8, k, stride, padding) == jf.conv_fwd_flops(
            h * 4, h * 4, 3, 8, k, stride, padding)


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-9)


def _dense_convt_flops(dataset, ngf, nz):
    """G's FLOPs with every kernel tap of every input pixel counted, edge
    taps included: FlopCounterMode's convention for a transposed conv."""
    total, size, cin = 0.0, 1, nz
    for features, k, stride, pad in generator_spec(dataset, ngf, 3):
        total += 2.0 * size * size * k * k * cin * features
        size = size + k - 1 if pad == "VALID" else size * stride
        cin = features
    return total


# The networks live on the meta device: FlopCounterMode counts from shapes.
@pytest.mark.parametrize("dataset,ngf,nz", [("cifar10", 128, 128), ("svhn", 64, 100)])
def test_generator_count_against_the_counter(dataset, ngf, nz):
    """The counter charges a transposed conv its dense taps; the model its
    exact taps (edge clipping, JAX's and XLA's convention). So the counter
    must equal the dense count, the model lie at or below it, and, on
    cifar10, whose clipping is small, within 0.15 of it (on svhn's 4x4
    stride-2 layers the clipped taps are 21% of the dense count)."""
    with torch.device("meta"):
        g = make_generator(dataset, ngf=ngf, nc=3, nz=nz)
        got = pf.counted_flops(g, torch.zeros(B, nz))
    model = B * pf.generator_fwd_flops(dataset, ngf, 3, nz)
    assert got == B * _dense_convt_flops(dataset, ngf, nz)
    assert model <= got
    if dataset == "cifar10":
        assert _rel(got, model) < 0.15


def test_encoder_count_against_the_counter():
    with torch.device("meta"):
        enc = make_encoder("cifar10", nemb=1024, nif=64, nc=3)
        got = pf.counted_flops(enc, torch.zeros(B, 32, 32, 3))
    assert _rel(got, B * pf.encoder_fwd_flops("cifar10", 1024, 64, 32)) < 0.15


def test_ebm_count_against_the_counter():
    with torch.device("meta"):
        got = pf.counted_flops(LatentEBM(128, ndf=200), torch.zeros(B, 128))
    assert _rel(got, B * pf.ebm_fwd_flops(128, 200)) < 0.10


def test_denoiser_eval_count_against_the_counter():
    """One hoisted denoiser eval (`denoise_from_tables`): all four products
    of every layer and the Fourier projection (the tables are counted
    apart)."""
    nz, nxemb, ntemb, nf = 128, 1024, 128, 4
    with torch.device("meta"):
        q = DAMCAmortizer(nz=nz, nxemb=nxemb, ntemb=ntemb, nf=nf, dataset="cifar10")
        tables = q.p.sample_tables(torch.zeros(4), torch.zeros(B, nxemb))
        pre_t_step = [t[0] for t in tables["pre_t"]]
        got = pf.counted_flops(q.p.denoise_from_tables, torch.zeros(B, nz), pre_t_step, tables["pre_x"])
    assert _rel(got, B * pf.denoiser_fwd_flops(nz, nxemb, ntemb, nf)) < 0.15


@pytest.mark.parametrize("res", [32, 256])
def test_inversion_counts_unchanged(res):
    """The StyleGAN half keeps its counts: each network's equal to JAX's, and
    `inversion_phase_flops` its parts (`encoder` apart from `sweep`)."""
    _close(pf.stylegan_synthesis_fwd_flops(res), jf.stylegan_synthesis_fwd_flops(res))
    _close(pf.stylegan_encoder_fwd_flops(res), jf.stylegan_encoder_fwd_flops(res))
    _close(pf.vgg16_fwd_flops(res), jf.vgg16_fwd_flops(res))
    got = pf.inversion_phase_flops(8, res)
    assert set(got) == {"encoder", "sweep", "feat_x", "adam", "rescue_final", "total"}
    want = jf.inversion_phase_flops(8, res)
    _close(got["encoder"], 8 * want["encoder_fwd_per_image"])
    _close(got["total"], want["total"])


def test_peak_table():
    assert pf.peak_flops("NVIDIA H100 80GB HBM3") == 67e12
    assert pf.peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert pf.peak_flops("NVIDIA A100-SXM4-80GB") is None
