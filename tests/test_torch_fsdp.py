"""Scattered parameters in the port (A10b, nkbx's ``fsdp``): the scattered
step of 2 ranks against the replicated step of 2 ranks, against one process,
and against nkbx's FSDP step.

- Specs, no spawn: the port's ``param_shardings``/``state_shardings`` on the
  carried-over variables of ``resnet_tiny_test`` and a tiny ViT against
  nkbx's on the same leaves (which leaves scatter, and the elements a rank
  holds of each), at ``make_mesh(n_data=2)`` and ``n_data=8`` (the virtual
  devices of tests/conftest.py), at ``fsdp_min_size`` 64 and at the default.
  The parameters, moments and EMA parameters agree; the BatchNorm running
  statistics stay replicated in the port (ROADMAP.md §C), which nkbx also
  does at its default threshold.
- ``step``: 2 gloo ranks (this file run as a script, tests/test_torch_dist.py's
  :func:`spawn`) run each scenario of SCENARIOS three ways from the same
  weights and batches: one process on the global batch, 2 ranks replicated,
  2 ranks scattered (``fsdp_min_size`` 64, so that most leaves scatter).
  Scattered against replicated: the losses, the gathered parameters and
  running statistics, the whole moments and the gathered EMA shadow bit for
  bit; the gradient norms within 1e-6 of their value (a scattered
  gradient's norm is the square root of the ranks' summed squares, the
  replicated one a single reduction: other roundings). Against one process:
  tests/test_torch_dist.py's tolerances (1e-5 of each tensor's largest), and
  2e-2 for the bf16 masters (each rank's bf16 gradient rounds before the sum
  over the ranks: a bf16 ulp is 3.9e-3 of a value). Also the collectives
  of the scattered state on their own, the state's bytes at rest, and the
  checkpoints: the file a scattered state writes equals the replicated
  state's byte for byte, and each resumes in the other layout.
- ``nkbx``: the port's scattered world of 2 against nkbx's step under
  ``make_mesh(n_data=2)`` with ``state_shardings(fsdp=True,
  fsdp_min_size=64)``, sgd as tests/test_sharding.py: losses within 1e-5
  relative, parameters and running statistics within 2e-5 of each tensor's
  largest value.
- The trainer CLI with ``fsdp = True`` on 2 ranks against ``fsdp = False``:
  ``metrics.csv`` within 1e-6 and the same weights files; ``fsdp`` with an
  explicit ``mesh=None`` raises nkbx's ValueError.
"""

import functools
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_dist import _batches, _worst, spawn  # noqa: E402

S, B, STEPS = 32, 8, 3
MIN = 64  # fsdp_min_size of the spawned scenarios: most leaves scatter
SGD = {"type": "sgd", "backbone_lr": 0.05, "classifier_lr": 0.05}
SGD_WD = dict(SGD, weight_decay=1e-2)
LR = 1e-3  # adam's and nadam's, both groups
ADAM = {"type": "adam", "lr": LR, "weight_decay": 1e-2}
NADAM = {"type": "nadam", "lr": LR, "weight_decay": 1e-2}
REL = 1e-5  # against one process (tests/test_torch_dist.py)
NORM_REL = 1e-6  # scattered norms against replicated ones, of a step's largest norm
BF16_REL = 2e-2  # bf16 masters against one process: the losses
# Adam and NAdam against one process: a gradient that is rounding noise (0 in
# exact arithmetic) has another sign in another sum order, and the update
# lr·m/(√v + eps) then moves its parameter by up to lr either way a step
ADAPTIVE_ABS = 2 * LR * STEPS

SCENARIOS = {
    "sgd_exact": {},
    "adam_masked": {"opt": ADAM, "masked_bn": True, "pad_last": 3},
    "accum": {"grad_accum_steps": 2, "masked_bn": True, "pad_last": 3},
    "scan": {"scan_steps": 2},
    "ema": {"opt": NADAM, "ema": True},
    "log_gradients": {"opt": SGD_WD, "log_gradients": True},
    "bf16_masters": {"bf16": True},
    "remat_convnext": {"net": "convnext"},
    "fused_vit": {"net": "vit", "opt": NADAM, "ema": True, "log_gradients": True},
    "fused_swin": {"net": "swin"},
}


def _model(sc):
    import torch

    from nkbx_torch.models import get_model
    from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier
    from nkbx_torch.models.convnext import ConvNeXt
    from nkbx_torch.models.swin import SwinTransformer
    from nkbx_torch.models.vit import ViT

    net = sc.get("net")
    if net is None:
        return get_model({"task": "single", "model": "resnet_tiny_test"}, list("abc"),
                         input_size=(S, S), seed=0, dtype=torch.float32, device="cpu")
    torch.manual_seed(0)
    if net == "vit":  # K3-K6's plain versions
        backbone = ViT(dtype=torch.float32, img_size=(S, S), patch_size=16, dim=64, depth=2,
                       n_heads=2, fused_attention=True, fused_mlp=True)
    elif net == "swin":  # K1/K2's and K5/K6's plain versions
        backbone = SwinTransformer(dtype=torch.float32, img_size=(S, S), embed_dim=16,
                                   depths=(2, 2), n_heads=(1, 2), window=2,
                                   fused_attention=True, fused_mlp=True)
    else:
        backbone = ConvNeXt(dtype=torch.float32, depths=(1, 1), dims=(16, 32),
                            remat_stages=(0, 1), fused_mlp=True)
    module = SingletaskClassifier(backbone, 3)
    with torch.no_grad():  # layer-scales of U[0.1, 1], so that the MLPs learn
        for name, p in module.named_parameters():
            if name.endswith("layer_scale"):
                p.uniform_(0.1, 1.0)
    return ClassificationModel(module, list("abc"), "single", backbone.num_features, (S, S),
                               torch.float32, torch.device("cpu"))


def _setup(sc, mesh, fsdp, seed=0):
    """(state, step) of a scenario: its model and options, the state
    scattered with ``fsdp``."""
    import torch

    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
    from nkbx_torch.transforms import spec as T

    model = _model(sc)
    state = TrainState.create(model, seed=seed, ema=sc.get("ema", False),
                              master_dtype=torch.bfloat16 if sc.get("bf16") else None,
                              mesh=mesh, fsdp=fsdp, fsdp_min_size=MIN)
    step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}),
                            get_optimizer(sc.get("opt", SGD)),
                            augment_fn=T.Compose([T.HorizontalFlip(), T.Normalize()]).device_apply,
                            masked_bn=sc.get("masked_bn", False),
                            grad_accum_steps=sc.get("grad_accum_steps", 1),
                            scan_steps=sc.get("scan_steps", 1),
                            ema_decay=0.9 if sc.get("ema") else 0.0,
                            log_gradients=sc.get("log_gradients", False), mesh=mesh)
    return state, step


def _calls(sc, mesh, seed):
    """Each call's (image, label, mask) of a scenario: the global batch
    without ``mesh``, this rank's rows under it; (K, b, ...) with
    ``scan_steps`` = K."""
    import torch

    k = sc.get("scan_steps", 1)
    batches = _batches(seed, STEPS + (k > 1), sc.get("pad_last", 0))
    rows = mesh.rows(B // mesh.data) if mesh is not None else slice(None)

    def cut(v, i):
        v = v[i:i + k][:, rows] if k > 1 else v[i][rows]
        return torch.from_numpy(np.ascontiguousarray(v))

    return [tuple(cut(v, i) for v in batches) for i in range(0, len(batches[0]), k)]


def _run(sc, mesh, seed, fsdp):
    """A scenario's steps. Returns (losses, gradient norms, the whole state
    as {key: numpy array}, the state)."""
    state, step = _setup(sc, mesh, fsdp)
    losses, norms = [], []
    for image, label, mask in _calls(sc, mesh, seed):
        state, m = step(state, image, label, mask, 1.0, 1.0)
        losses.extend(np.ravel(m["loss"].float().numpy()).tolist())
        if "grad_norms" in m:
            norms.append({key: float(v) for key, v in m["grad_norms"].items()})
    return losses, norms, whole_state(state), state


def whole_state(state) -> dict:
    """The state gathered, as host numpy arrays: ``module/<key>``,
    ``ema/<key>``, ``<group>/mu/<i>`` and ``<group>/nu/<i>``."""
    import torch

    out = {}
    with state.gathered(state.module), state.gathered(state.ema_module):
        for part, m in (("module", state.module), ("ema", state.ema_module)):
            if m is not None:
                for k, v in m.state_dict().items():
                    out[f"{part}/{k}"] = v.detach().to(torch.float32).numpy().copy()
        for label, st in state.opt_state.items():
            for kind in ("mu", "nu"):
                for i, t in enumerate(state.whole(state.groups[label], getattr(st, kind))):
                    out[f"{label}/{kind}/{i}"] = t.to(torch.float32).numpy().copy()
    return out


def _collectives_case(rank, n):
    """The scattered state's collectives on CPU tensors against sums worked
    out here."""
    import torch

    from nkbx_torch.parallel import collectives as C

    a = torch.arange(12, dtype=torch.float32).reshape(3, 4) * (rank + 1)
    b = torch.full((2, 2), float(rank + 1), dtype=torch.bfloat16)
    rs = C.reduce_scatter_grads([a, b], [1, 0])
    shards = [torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * rank,
              torch.full((1, 3), rank, dtype=torch.bfloat16)]
    ag = C.all_gather_shards(shards, [1, 0])
    return {"rs": [t.float().tolist() for t in rs], "rs_dtypes": [str(t.dtype) for t in rs],
            "ag": [t.float().tolist() for t in ag], "ag_dtypes": [str(t.dtype) for t in ag]}


def _bytes_case(mesh):
    """The ViT-like state's bytes at rest, replicated and scattered (nadam
    moments and an EMA shadow), at the default fsdp_min_size, and the
    module's scattered parameters' storage."""
    from nkbx_torch.train import TrainState

    out = {}
    for fsdp in (False, True):
        state = TrainState.create(_model({"net": "vit"}), ema=True, mesh=mesh, fsdp=fsdp)
        out[str(fsdp)] = state.nbytes()
        if fsdp:
            scat = state.scatter_of(state.module)
            out["scattered"] = len(scat.params)
            # four copies of each scattered leaf (master, two moments, EMA), halved
            out["want"] = out["False"] - sum(
                4 * s.numel() * s.element_size() * (mesh.data - 1) for _, _, s in scat.params)
            out["empty"] = all(p.numel() == 0 for p, _, _ in scat.params)
            with state.gathered(state.module):
                out["gathered_shapes_ok"] = all(
                    tuple(p.shape) == scat.shapes[n] for n, p in state.module.named_parameters())
            out["released"] = all(p.numel() == 0 for p, _, _ in scat.params)
    return out


def _checkpoint_case(mesh, out_dir):
    """Checkpoints of the ``ema`` scenario (nadam, EMA) written by the
    scattered and the replicated state: their files, and each restored into
    the other layout and stepped once more."""
    import torch

    from nkbx_torch.train.checkpoint import (STATE_FILE, restore_train_state, save_checkpoint,
                                             save_weights)

    sc = SCENARIOS["ema"]
    res, states = {}, {}
    for fsdp in (False, True):
        *_, states[fsdp] = _run(sc, mesh, 40, fsdp)
        save_checkpoint(out_dir / f"ckpt_{fsdp}", states[fsdp], epoch=1, best_val_acc=0.5)
        (out_dir / f"w_{fsdp}").mkdir(exist_ok=True)  # a file's name is in its bytes
        save_weights(out_dir / f"w_{fsdp}" / "last.pt", states[fsdp].ema_module, states[fsdp])
    files = [(out_dir / f"ckpt_{f}" / STATE_FILE).read_bytes() for f in (False, True)]
    weights = [(out_dir / f"w_{f}" / "last.pt").read_bytes() for f in (False, True)]
    res["same_bytes"] = files[0] == files[1]
    res["same_weight_bytes"] = weights[0] == weights[1]
    a, b = (torch.load(out_dir / f"ckpt_{f}" / STATE_FILE, weights_only=True)
            for f in (False, True))
    res["same_tensors"] = _same(a, b)
    image, label, mask = _calls(sc, mesh, 41)[0]
    resumed = {}
    for fsdp in (False, True):  # each file into the other layout, then one more step
        state, step = _setup(sc, mesh, fsdp, seed=5)
        state, epoch, best = restore_train_state(out_dir / f"ckpt_{not fsdp}", state)
        res[f"restored_{fsdp}"] = _max_diff(whole_state(state), whole_state(states[not fsdp]))
        res[f"meta_{fsdp}"] = [epoch, best, state.step]
        state, _ = step(state, image, label, mask, 1.0, 1.0)
        resumed[fsdp] = whole_state(state)
    res["resumed_diff"] = _max_diff(resumed[True], resumed[False])
    return res


def _same(a, b) -> bool:
    """Nested payloads equal: tensors bit for bit, everything else by ==."""
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a == b


def _max_diff(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    return max(float(np.abs(got[k] - want[k]).max(initial=0.0)) for k in want)


def _norms_err(got, want):
    """The largest difference of a step's gradient norms over that step's
    largest norm."""
    return max((abs(b[k] - a[k]) / max(max(a.values()), 1e-30)
                for a, b in zip(want, got) for k in a), default=0.0)


def _abs_err(got, want, keys):
    return max(float(np.abs(got[k] - want[k]).max(initial=0.0)) for k in keys)


def rank_step(out_dir):
    from nkbx_torch.core.runtime import initialize
    from nkbx_torch.parallel import make_mesh

    initialize(distributed=True, device="cpu")
    mesh = make_mesh()
    res = {"collectives": _collectives_case(mesh.rank, mesh.data),
           "bytes": _bytes_case(mesh), "scenarios": {}}
    for i, (name, sc) in enumerate(SCENARIOS.items()):
        l1, n1, s1, _ = _run(sc, None, 10 + i, False)
        l2, n2, s2, _ = _run(sc, mesh, 10 + i, False)
        l3, n3, s3, st3 = _run(sc, mesh, 10 + i, True)
        scat = st3.scatter_of(st3.module)
        res["scenarios"][name] = {
            "losses": [l1, l2, l3],
            "bit_equal": [k for k in s2 if not np.array_equal(s2[k], s3[k])],
            "keys_equal": s2.keys() == s3.keys(),
            "norms_vs_replicated": _norms_err(n3, n2), "n_norms": len(n3),
            "vs_world1": _worst({k: v for k, v in s3.items() if k.startswith(("module", "ema"))},
                                {k: v for k, v in s1.items() if k.startswith(("module", "ema"))}),
            "abs_vs_world1": _abs_err(s3, s1, [k for k in s1 if k.startswith(("module", "ema"))]),
            "norms_vs_world1": _norms_err(n3, n1),
            "scattered": len(scat.params), "whole": len(scat.replicated),
            "digest": hashlib.sha256(b"".join(s3[k].tobytes() for k in sorted(s3))).hexdigest(),
        }
    res["checkpoint"] = _checkpoint_case(mesh, Path(out_dir))
    (Path(out_dir) / f"rank{mesh.rank}.json").write_text(json.dumps(res))


def rank_nkbx(out_dir, data):
    """The port's scattered world of 2 from the variables and batches the
    test saved, exact and masked BatchNorm."""
    import torch

    from nkbx_torch.core.runtime import initialize
    from nkbx_torch.models import get_model
    from nkbx_torch.parallel import make_mesh
    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
    from nkbx_torch.transforms import spec as T

    initialize(distributed=True, device="cpu")
    mesh = make_mesh()
    saved = torch.load(Path(data) / "inputs.pt", weights_only=False)
    for case, masked in (("exact", False), ("masked", True)):
        model = get_model({"task": "single", "model": "resnet_tiny_test"}, list("abc"),
                          input_size=(S, S), dtype=torch.float32, device="cpu")
        model.module.load_state_dict(saved["state_dict"])
        state = TrainState.create(model, mesh=mesh, fsdp=True, fsdp_min_size=MIN)
        step = build_train_step(model, get_loss({"type": "CrossEntropyLoss"}), get_optimizer(SGD),
                                augment_fn=T.Compose([T.Normalize()]).device_apply,
                                masked_bn=masked, mesh=mesh)
        rows = mesh.rows(B // 2)
        mask = saved["mask"] if masked else np.ones(B, bool)
        losses = []
        for i in range(STEPS):
            state, m = step(state, torch.from_numpy(saved["images"][i][rows]),
                            torch.from_numpy(saved["labels"][i][rows]),
                            torch.from_numpy(mask[rows]), 1.0, 1.0)
            losses.append(float(m["loss"]))
        with state.gathered(state.module):
            sd = {k: v.clone() for k, v in model.module.state_dict().items()}
        torch.save({"losses": losses, "state_dict": sd,
                    "scattered": len(state.scatter_of(state.module).params)},
                   Path(out_dir) / f"{case}{mesh.rank}.pt")
    (Path(out_dir) / f"rank{mesh.rank}.json").write_text(json.dumps({"ok": True}))


# --- the tests ---------------------------------------------------------------------------


def _close(a, b, rel=REL):
    return abs(a - b) <= rel * max(abs(b), 1e-30)


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    return spawn("step", tmp_path_factory.mktemp("fsdp_step"), script=__file__)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scattered_step_equals_replicated_and_world_one(step_runs, name):
    a, b = (run["scenarios"][name] for run in step_runs)
    assert a["digest"] == b["digest"], name  # every rank gathers the same state
    assert a["scattered"] > 0 and a["whole"] > 0, a  # both kinds of leaf on the path
    l1, l2, l3 = a["losses"]
    assert l3 == l2 and b["losses"][2] == l3, (l2, l3)  # bit for bit, the global loss
    assert a["keys_equal"] and a["bit_equal"] == [], a["bit_equal"][:5]
    assert a["norms_vs_replicated"] <= NORM_REL, a["norms_vs_replicated"]
    if SCENARIOS[name].get("bf16"):
        # each rank's bf16 gradient rounds its partial sum before the sum over
        # the ranks; where the partials cancel (a BatchNorm bias's gradient
        # sums to near 0) a parameter takes other bf16 steps than one
        # process's (0.8% of a largest value here), so the losses alone are
        # held to one process; the scattered step is held to the replicated
        # step of 2 ranks bit for bit above, the comparison fsdp changes
        assert all(_close(x, y, BF16_REL) for x, y in zip(l3, l1)), (l1, l3)
        return
    assert all(_close(x, y) for x, y in zip(l3, l1)), (l1, l3)
    if SCENARIOS[name].get("opt", SGD)["type"] == "sgd":
        assert a["vs_world1"][0] <= REL, a["vs_world1"]
    else:
        assert a["abs_vs_world1"] <= ADAPTIVE_ABS, a["abs_vs_world1"]
    assert a["norms_vs_world1"] <= REL, a["norms_vs_world1"]
    if SCENARIOS[name].get("log_gradients"):
        assert a["n_norms"] == STEPS


def test_scattered_collectives(step_runs):
    """reduce_scatter_grads and all_gather_shards on 2 ranks."""
    for r, run in enumerate(step_runs):
        c = run["collectives"]
        base = np.arange(12, dtype=np.float32).reshape(3, 4) * 3  # ranks 1 and 2 summed
        assert c["rs"][0] == base[:, 2 * r:2 * r + 2].tolist()
        assert c["rs"][1] == [[3.0, 3.0]]  # block r of the (2, 2) bf16 sum along dim 0
        assert c["rs_dtypes"] == ["torch.float32", "torch.bfloat16"]
        blocks = [np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * q for q in range(2)]
        assert c["ag"][0] == np.concatenate(blocks, axis=1).tolist()
        assert c["ag"][1] == [[0.0] * 3, [1.0] * 3]
        assert c["ag_dtypes"] == ["torch.float32", "torch.bfloat16"]


def test_state_at_rest_holds_shards(step_runs):
    """At the default fsdp_min_size a rank's state at rest (f32 masters,
    nadam moments, the EMA shadow) holds a half of each scattered leaf and
    the whole of the others (the tiny ViT: its patch embedding and MLP
    kernels scatter); the module's scattered parameters hold no storage but inside a
    gather."""
    for run in step_runs:
        got = run["bytes"]
        assert got["scattered"] == 5 and got["empty"] and got["released"], got
        assert got["gathered_shapes_ok"]
        assert got["True"] == got["want"] < 0.75 * got["False"], got


def test_checkpoints_equal_and_resume_across_layouts(step_runs):
    c = step_runs[0]["checkpoint"]
    assert c["same_bytes"] and c["same_weight_bytes"] and c["same_tensors"]
    for fsdp in ("True", "False"):
        assert c[f"restored_{fsdp}"] == 0.0, c
        assert c[f"meta_{fsdp}"] == [1, 0.5, STEPS]
    assert c["resumed_diff"] == 0.0, c
    assert step_runs[1]["checkpoint"] == c  # every rank joined the same gathers


def test_port_scattered_world_of_two_equals_nkbx_fsdp_step(tmp_path):
    """nkbx's step under make_mesh(n_data=2), its state on
    state_shardings(fsdp=True, fsdp_min_size=64), against the port's 2
    scattered ranks."""
    import jax
    import jax.numpy as jnp
    import torch

    from nkbx.models import get_model as jget_model
    from nkbx.parallel import make_mesh, shard_batch
    from nkbx.parallel import state_shardings as jstate_shardings
    from nkbx.train import TrainState as JState
    from nkbx.train import build_train_step as jstep
    from nkbx.train import get_loss as jloss
    from nkbx.train import get_optimizer as jopt
    from nkbx.transforms import spec as jspec
    from nkbx_torch.models.convert import from_jax_variables

    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (STEPS, B, S, S, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (STEPS, B)).astype(np.int64)
    mask = np.ones(B, bool)
    mask[-3:] = False
    images[:, -3:] = 0
    jmodel = jget_model({"task": "single", "model": "resnet_tiny_test"}, list("abc"),
                        input_size=(S, S), dtype=jnp.float32)
    variables = jax.device_get(jmodel.variables)
    data = tmp_path / "data"
    data.mkdir()
    torch.save({"state_dict": from_jax_variables(variables), "images": images,
                "labels": labels, "mask": mask}, data / "inputs.pt")
    spawn("nkbx", tmp_path / "port", extra=(str(data),), script=__file__)
    mesh = make_mesh(n_data=2)
    for case, masked in (("exact", False), ("masked", True)):
        bundle = jopt(jmodel.params, SGD)
        step = jstep(jmodel, jloss({"type": "CrossEntropyLoss"}), bundle,
                     augment_fn=jspec.Compose([jspec.Normalize()]).device_apply,
                     masked_bn=masked)
        state = JState.create(variables["params"], variables["batch_stats"], bundle.tx)
        state = jax.device_put(state, jstate_shardings(mesh, state, fsdp=True,
                                                       fsdp_min_size=MIN))
        m = mask if masked else np.ones(B, bool)
        losses = []
        for i in range(STEPS):
            batch = shard_batch(mesh, {"image": images[i], "label": labels[i], "mask": m})
            state, metrics = step(state, batch["image"], batch["label"], batch["mask"],
                                  jax.random.PRNGKey(0), jnp.asarray(1.0, jnp.float32),
                                  jnp.asarray(1.0, jnp.float32))
            losses.append(float(metrics["loss"]))
        want = from_jax_variables(jax.device_get({"params": state.params,
                                                  "batch_stats": state.batch_stats}))
        for r in range(2):
            got = torch.load(tmp_path / "port" / f"{case}{r}.pt")
            assert got["scattered"] > 10
            assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got["losses"], losses)), (
                case, got["losses"], losses)
            for key, w in want.items():
                g, w = got["state_dict"][key].numpy(), w.numpy()
                err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
                assert err <= 2e-5, (case, r, key, err)


def test_trainer_cli_fsdp_equals_replicated(tmp_path):
    """``python -m nkbx_torch.train`` on 2 ranks with ``fsdp = True`` against
    ``fsdp = False`` (tests/test_torch_dist_cli.py's config: sgd, flips, a
    frozen first epoch, 2 epochs): every metrics.csv value within 1e-6
    relative but the throughput, and the same checkpoint and weights files."""
    import torch

    from test_torch_dist_cli import _config, _folder, _read_csv, _torchrun

    data = _folder(tmp_path / "data")
    logs = {}
    for fsdp in (False, True):
        cfg = tmp_path / f"fsdp_{fsdp}.py"
        cfg.write_text(_config(data, tmp_path / f"run_{fsdp}", True, extra=f"fsdp = {fsdp}\n"))
        proc = _torchrun("nkbx_torch.train", cfg)
        logs[fsdp] = proc.stdout + proc.stderr
    assert "rank 1 of 2" in logs[True] and "scattered over 2 ranks" in logs[True]
    assert "fsdp:" not in logs[False]
    a, b = (_read_csv(tmp_path / f"run_{f}" / "metrics.csv") for f in (False, True))
    assert a[0] == b[0] and len(a) == len(b) == 3
    for col, name in enumerate(a[0]):
        if name == "train images/sec/chip":  # a clock reading
            continue
        for ra, rb in zip(a[1:], b[1:]):
            assert _close(float(rb[col]), float(ra[col]), 1e-6), (name, ra[col], rb[col])
    weights = [tmp_path / f"run_{f}" / "weights" for f in (False, True)]
    for f in ("best.pt", "last.pt"):
        want, got = (torch.load(w / f) for w in weights)
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    for d in ("best", "last"):
        assert ((weights[0] / d / "train_state.pt").read_bytes()
                == (weights[1] / d / "train_state.pt").read_bytes())


# --- the specs against nkbx's ------------------------------------------------------------


def _nkbx_leaves(state, shardings, n):
    """{(part, flax path): elements a rank holds} of nkbx's train state:
    parts params, ema_params, mu, nu, batch_stats, ema_batch_stats."""
    import jax

    out = {}
    specs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    for (path, leaf), sh in zip(jax.tree_util.tree_flatten_with_path(state)[0], specs):
        keys = [getattr(k, "name", None) or getattr(k, "key", None) for k in path]
        keys = [k for k in keys if isinstance(k, str)]
        if keys[0] == "opt_state":
            if not {"mu", "nu"} & set(keys):
                continue
            kind = "mu" if "mu" in keys else "nu"
            part, rest = kind, keys[keys.index(kind) + 1:]
        else:
            part, rest = keys[0], keys[1:]
        if part == "step":
            continue
        if part in ("batch_stats", "ema_batch_stats"):
            rest = rest[:-1] + ["running_" + rest[-1]]
        scattered = "data" in tuple(sh.spec)
        out[(part, "/".join(rest))] = int(leaf.size) // (n if scattered else 1)
    return out


def _port_leaves(state, specs, n):
    """The same of the port's state and its state_shardings."""
    from nkbx_torch.models.convert import flax_param_path

    def held(shape, spec):
        return int(np.prod(shape)) // (n if "data" in spec else 1)

    shapes = state.param_shapes()
    params = dict(state.module.named_parameters())
    sd = {k: tuple(v.shape) for k, v in state.module.state_dict().items()}
    out = {}
    for part, ema in (("params", False), ("ema_params", True)):
        for key, spec in specs["ema" if ema else "module"].items():
            if key in params:
                out[(part, flax_param_path(key, params[key]))] = held(shapes[key], spec)
            elif "running" in key:
                stats = "ema_batch_stats" if ema else "batch_stats"
                prefix, leaf = key.rsplit(".", 1)
                out[(stats, prefix.replace(".", "/") + "/" + leaf)] = held(sd[key], spec)
    for label, st in specs["opt_state"].items():
        for kind in ("mu", "nu"):
            for name, spec in zip(state.names[label], st[kind]):
                out[(kind, flax_param_path(name, params[name]))] = held(shapes[name], spec)
    return out


@functools.lru_cache(maxsize=None)
def _family(family):
    """(nkbx's params, nkbx's train state with nadam and EMA, the port's
    state of the carried-over variables) of resnet_tiny_test or a tiny ViT
    (dim 128, depth 2: its qkv and MLP kernels pass 2^14 elements)."""
    import jax
    import jax.numpy as jnp
    import torch

    from nkbx.models import get_model as jget_model
    from nkbx.models.classifier import SingletaskClassifier as JSingle
    from nkbx.models.vit import ViT as JViT
    from nkbx.train import TrainState as JState
    from nkbx.train import get_optimizer as jopt
    from nkbx_torch.models import from_jax_variables, get_model
    from nkbx_torch.models.classifier import SingletaskClassifier
    from nkbx_torch.models.vit import ViT
    from nkbx_torch.train import TrainState

    if family == "resnet":
        jmodel = jget_model({"task": "single", "model": "resnet_tiny_test"}, list("abc"),
                            input_size=(S, S), dtype=jnp.float32)
        variables = jax.device_get(jmodel.variables)
        module = get_model({"task": "single", "model": "resnet_tiny_test"}, list("abc"),
                           input_size=(S, S), dtype=torch.float32, device="cpu").module
    else:
        tiny = dict(patch_size=16, dim=128, depth=2, n_heads=2)
        jmodule = JSingle(backbone=JViT(dtype=jnp.float32, **tiny), n_classes=3)
        variables = jax.device_get(jmodule.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 64, 64, 3)), train=False))
        module = SingletaskClassifier(ViT(dtype=torch.float32, img_size=(64, 64), **tiny), 3)
    module.load_state_dict(from_jax_variables(variables, reference=module))
    params = variables["params"]
    bundle = jopt(params, {"type": "nadam", "lr": 1e-3})
    jstate = JState.create(params, variables.get("batch_stats", {}), bundle.tx, ema=True)
    return params, jstate, TrainState.create(module, ema=True)


@pytest.mark.parametrize("family", ["resnet", "vit"])
@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("min_size", [64, None])
def test_specs_equal_nkbx(family, n, min_size):
    """Which leaves scatter, and the elements a rank holds of each, for the
    parameters, moments and EMA parameters, as nkbx's rule says; the
    running statistics whole in the port, as in nkbx at its default."""
    import jax

    from nkbx.parallel import make_mesh as jmake_mesh
    from nkbx.parallel import param_shardings as jparam_shardings
    from nkbx.parallel import state_shardings as jstate_shardings
    from nkbx_torch.parallel import Mesh, param_shardings, state_shardings

    params, jstate, state = _family(family)
    kw = {} if min_size is None else {"fsdp_min_size": min_size}
    jmesh, mesh = jmake_mesh(n_data=n), Mesh(data=n)
    want = _nkbx_leaves(jstate, jstate_shardings(jmesh, jstate, **kw), n)
    got = _port_leaves(state, state_shardings(mesh, state, **kw), n)
    assert got.keys() == want.keys()
    stats = {k for k in want if k[0].endswith("batch_stats")}
    assert {k: v for k, v in got.items() if k not in stats} == {
        k: v for k, v in want.items() if k not in stats}
    for k in stats:
        assert got[k] >= want[k], k
        if min_size is None:
            assert got[k] == want[k], k
    specs = param_shardings(mesh, state.module, fsdp=True, **kw)
    jspecs = jax.tree_util.tree_leaves(jparam_shardings(jmesh, params, fsdp=True, **kw),
                                       is_leaf=lambda x: hasattr(x, "spec"))
    assert sum(bool(v) for v in specs.values()) == sum(
        s.spec != jax.sharding.PartitionSpec() for s in jspecs) > 0
    assert param_shardings(mesh, state.module) == {k: () for k in specs}  # fsdp off


def test_fsdp_refusals_and_a_world_of_one():
    """nkbx's errors: fsdp without a mesh; the model axis and
    tensor_parallel refused by design (A10b); over one data rank nothing
    scatters (nkbx's rule at n_data = 1)."""
    import torch

    from nkbx_torch.models import get_model
    from nkbx_torch.parallel import Mesh, make_mesh, param_shardings
    from nkbx_torch.train import TrainState
    from nkbx_torch.train.trainer import train
    from nkbx_torch.utils import Config

    model = get_model({"task": "single", "model": "resnet_tiny_test"}, list("abc"),
                      input_size=(S, S), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="fsdp=True requires a mesh"):
        TrainState.create(model, fsdp=True)
    with pytest.raises(ValueError, match="fsdp=True requires a mesh"):
        train(model, None, None, None, None, None, Config({"task": "single", "fsdp": True}),
              mesh=None)
    with pytest.raises(NotImplementedError, match="A10b.*only replicates"):
        make_mesh(n_data=1, n_model=2)
    with pytest.raises(NotImplementedError, match="A10b"):
        param_shardings(Mesh(data=2), model.module, tensor_parallel=True)
    state = TrainState.create(model, mesh=make_mesh(), fsdp=True, fsdp_min_size=1)
    assert state.scattered == ()
    assert state.tensors() == [p for g in state.groups.values() for p in g]
    assert all(p.numel() > 0 for p in model.module.parameters())


if __name__ == "__main__":
    import torch.distributed as dist

    group, out = sys.argv[1], sys.argv[2]
    {"step": lambda: rank_step(out), "nkbx": lambda: rank_nkbx(out, sys.argv[3])}[group]()
    dist.barrier()
    dist.destroy_process_group()
