"""The plain references against the program's plain paths on the CPU at a
tiny size: the same seeded weights give the same logits, the flips and
Normalize the same batch, NAdam the same update."""

import pytest
import torch

from h100_bench import weights
from h100_bench.drivers.train import reference_shapes
from h100_bench.reference import optim_nadam
from h100_bench.reference.train import device_stage, optimizer
from h100_bench.tests.tiny import tiny_cell

SEED = 2**31 + 77


def _program(cell):
    from nkbx_torch.models import get_model

    cfg = cell.config
    model = get_model({"task": "single", "model": cfg["model"],
                       "backbone_opts": cfg.get("backbone_opts") or {}},
                      [str(i) for i in range(cfg["num_classes"])],
                      input_size=(cfg["image_size"],) * 2, dtype=torch.float32, device="cpu")
    weights.load(model.module, weights.make(reference_shapes(cell), SEED, "cpu"))
    return model.module


@pytest.mark.parametrize("name", ["vit_b16.train.b128", "convnext_t.train.b128"])
def test_reference_logits_match_the_program_in_f32(name):
    cell = tiny_cell(name)
    ref = cell.family.build(cell.config)
    weights.load(ref, weights.make(reference_shapes(cell), SEED, "cpu"))
    prog = _program(cell)
    x = device_stage(weights.uint8_images(3, cell.config["image_size"], SEED, "cpu"), cell.mix)
    with torch.no_grad():
        want, got = ref(x), prog(x)
    assert got.shape == want.shape == (3, 10)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_parameter_names_and_shapes_are_the_programs():
    for name in ("vit_b16.train.b128", "convnext_t.train.b128"):
        cell = tiny_cell(name)
        prog = {n: tuple(p.shape) for n, p in _program(cell).named_parameters()}
        assert prog == dict(reference_shapes(cell))


def test_flips_and_normalize_match_the_program():
    from nkbx_torch import transforms as T

    cell = tiny_cell("vit_b16.train.b128")
    mix = cell.mix
    img = weights.uint8_images(16, 8, SEED, "cpu")
    norm = mix["normalize"]
    stage = T.Compose([T.HorizontalFlip(p=0.5), T.VerticalFlip(p=0.5),
                       T.Normalize(mean=norm["mean"], std=norm["std"])])
    got = stage.device_apply(img, out_dtype=torch.float32,
                             generator=torch.Generator().manual_seed(5))
    want = device_stage(img, mix, torch.Generator().manual_seed(5))
    assert torch.allclose(got, want, atol=1e-5)
    assert not torch.allclose(want, device_stage(img, mix), atol=1e-5)  # some rows flipped


def test_nadam_matches_the_programs_update():
    from nkbx_torch.train import get_optimizer
    from nkbx_torch.train.optim import apply_updates, init_opt_state

    cfg = tiny_cell("vit_b16.train.b128").mix["optimizer"]
    g = torch.Generator().manual_seed(3)
    model = torch.nn.Module()
    model.backbone = torch.nn.Linear(6, 5)
    model.head = torch.nn.Linear(5, 3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    twin = {n: p.detach().clone() for n, p in model.named_parameters()}
    ref = torch.nn.Module()
    ref.backbone = torch.nn.Linear(6, 5)
    ref.head = torch.nn.Linear(5, 3)
    with torch.no_grad():
        for n, p in ref.named_parameters():
            p.copy_(twin[n])
    groups = {"backbone": list(model.backbone.parameters()),
              "classifier": list(model.head.parameters())}
    state = init_opt_state(groups)
    bundle = get_optimizer(cfg)
    opt = optimizer(ref, cfg)
    assert optim_nadam.make.__module__.endswith("optim_nadam")
    for _ in range(3):
        grads = {n: torch.randn(p.shape, generator=g) for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        for n, p in ref.named_parameters():
            p.grad = grads[n].clone()
        apply_updates(bundle, state, groups, 1.0, 1.0)
        opt.step()
    for (n, p), (_, q) in zip(model.named_parameters(), ref.named_parameters()):
        # the two sum the update's terms in different orders: a few float32 ulps apart
        assert torch.allclose(p, q, rtol=8 * torch.finfo(torch.float32).eps, atol=0), n
