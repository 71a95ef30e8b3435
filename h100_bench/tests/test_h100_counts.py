"""The yardstick's arithmetic: model FLOPs and the roofline work counts."""

import pytest

from h100_bench import spec, work
from h100_bench.reference import convnext, vit

H100 = (989e12, 3.35e12)


def _cfg(name):
    return spec.cell({"vit_b16": "vit_b16.train.b128",
                      "convnext_t": "convnext_t.train.b128"}[name]).config


def test_vit_b16_macs_follow_the_published_arithmetic():
    cfg = _cfg("vit_b16")
    # 12 blocks x (197 x 7.08 M + 59.6 M for QK^T and PV) + a 115.6 M patch embed + the head
    per_block = 197 * (4 * 768 ** 2 + 2 * 768 * 3072) + 2 * 197 ** 2 * 768
    assert vit.macs_per_image(cfg) == 12 * per_block + 196 * 768 * 768 + 768 * 1000
    assert vit.macs_per_image(cfg) / 1e9 == pytest.approx(17.57, abs=0.01)


def test_convnext_t_macs_follow_the_published_arithmetic():
    cfg = _cfg("convnext_t")
    assert convnext.macs_per_image(cfg) / 1e9 == pytest.approx(4.46, abs=0.01)
    # the stem alone: 56 x 56 outputs of a 4 x 4 x 3 -> 96 convolution
    tiny = dict(cfg, depths=[0, 0, 0, 0], num_classes=0)
    downs = 28 ** 2 * 4 * 96 * 192 + 14 ** 2 * 4 * 192 * 384 + 7 ** 2 * 4 * 384 * 768
    assert convnext.macs_per_image(tiny) == 56 * 56 * 48 * 96 + downs


def test_train_step_flops_are_three_forwards():
    cfg = _cfg("vit_b16")
    fwd = work.model_flops(vit, cfg, 128, train=False)
    assert fwd == 2 * vit.macs_per_image(cfg) * 128
    assert work.model_flops(vit, cfg, 128, train=True) == 3 * fwd


def test_ln_mlp_bound_at_a_small_shape():
    call = [dict(rows=64, c=32, f=128, shortcut=False, gamma=False)]
    fwd_bytes = 64 * 32 * 2 * 2 + 2 * 32 * 128 * 2 + (2 * 32 + 128 + 32) * 4
    fwd = max(4 * 64 * 32 * 128 / H100[0], fwd_bytes / H100[1])
    assert work.ln_mlp_bound_s(call, False, H100) == pytest.approx(fwd)
    bwd_bytes = 3 * 64 * 32 * 2 + 2 * 32 * 128 * 2 + 2 * 32 * 128 * 4 + (2 * 32 + 128 + 32) * 4
    bwd = max(8 * 64 * 32 * 128 / H100[0], bwd_bytes / H100[1])
    assert work.ln_mlp_bound_s(call, True, H100) == pytest.approx(fwd + bwd)
    # a shortcut apart from the input and a layer-scale read more
    more = [dict(call[0], shortcut=True, gamma=True)]
    assert work.ln_mlp_bound_s(more, False, H100) == pytest.approx(
        max(4 * 64 * 32 * 128 / H100[0], (fwd_bytes + 64 * 32 * 2 + 32 * 4) / H100[1]))


def test_attention_bound_at_a_small_shape():
    call = [dict(b=2, h=3, n=10, d=8)]
    t = 2 * 10 * 3 * 8 * 2
    fwd = max(4 * 2 * 3 * 100 * 8 / H100[0], 4 * t / H100[1])
    bwd = max(8 * 2 * 3 * 100 * 8 / H100[0], (8 * t + 2 * 3 * 10 * 4) / H100[1])
    assert work.attention_bound_s(call, False, H100) == pytest.approx(fwd)
    assert work.attention_bound_s(call, True, H100) == pytest.approx(fwd + bwd)


def test_layer_calls_follow_the_shapes():
    v, c = _cfg("vit_b16"), _cfg("convnext_t")
    assert vit.ln_mlp_calls(v, 2) == [dict(rows=394, c=768, f=3072, shortcut=False,
                                           gamma=False)] * 12
    assert vit.attention_calls(v, 2) == [dict(b=2, h=12, n=197, d=64)] * 12
    rows = [call["rows"] for call in convnext.ln_mlp_calls(c, 1)]
    assert rows == [3136] * 3 + [784] * 3 + [196] * 9 + [49] * 3
    assert convnext.attention_calls(c, 1) == []


def test_peaks_are_the_data_sheet_h100s():
    assert work.peaks("NVIDIA H100 80GB HBM3") == H100
    assert work.peaks("cpu") is None
