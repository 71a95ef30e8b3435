"""Data parallelism in the port (A10): ranks of a ``torch.distributed``
group against one process, and against nkbx's mesh step.

Each spawn starts 2 ranks (gloo on the CPU) as subprocesses of this file
run as a script (``python tests/test_torch_dist.py GROUP OUT``, torchrun's
environment variables set by :func:`spawn`), on a free port; a rank runs
every scenario of its group and writes ``OUT/rank<r>.json``, so that the
process start-up is paid once a group, not once a case.

- ``step``: the train step of a world of 2 (each rank its 4 rows of a global
  batch of 8) against the world of 1 on the same 8 rows, same seed, 3 steps
  (``scan``: 2 calls of 2): exact BatchNorm, masked BatchNorm with a padded
  last batch and class weights, ghost BatchNorm through the fused chain's
  plain version, CutMix and mixup with a padded batch (the partners live on
  the other rank), a flip + RandAugment device stage, ``grad_accum_steps=2``,
  ``scan_steps=2``, EMA, ``log_gradients``, a multi-task focal loss with
  ignored labels, and ``classifier_dropout`` with ``backbone_dropout`` at
  0.1, alone and with ``grad_accum_steps=2`` (every mask drawn for the
  global batch from the state's generator). Tolerances (f32, sgd): each loss within 1e-5 relative;
  each parameter, running statistic, EMA tensor and gradient norm within
  1e-5 of its tensor's largest value; the epoch's results of an exact and a
  bounded EpochCollector (gathered over the ranks) with equal predictions,
  labels and confusion counts, confidences and losses within 1e-5; the two ranks' parameters equal bit
  for bit. ``multitask`` holds its parameters and running statistics to a
  rounding yardstick instead (:data:`YARDSTICK`): a ReLU gate of its data
  lies within a few f32 ulps of 0 and falls either way under rounding alone.
  Also the collectives one by one, the refusals a rank meets, and
  a group of one rank (which runs the collectives) against no group.
- ``nkbx``: the port's world of 2, and its world of 1, against nkbx's step
  under ``make_mesh(n_data=2)`` on the virtual CPU devices of
  tests/conftest.py (state replicated, batch sharded), from the same
  variables and numpy batches, for exact BatchNorm, masked BatchNorm with
  padded rows, and a multi-task focal loss with ignored labels, masked
  BatchNorm and padded rows in the last step: the test that pins nkbx's
  global statistics and normalisers (loss 1e-5 relative, parameters and
  running statistics 2e-5 of the tensor's largest).
- ``nodes``: two ranks with ``LOCAL_WORLD_SIZE=1`` (two nodes of one rank)
  read nkbx's 2-process loader slices (``nkbx/data/loader.py:122-136``) row
  for row (exact), and one node of 2 ranks splits each node batch.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
B, S, STEPS = 8, 32, 3
SGD = {"type": "sgd", "backbone_lr": 0.05, "classifier_lr": 0.05}
REL = 1e-5
# Scenarios whose parameters and running statistics are held to twice the
# largest change that a 1-ulp perturbation of the normalised input makes in the
# world of 1, over YARD_DRAWS seeded draws (at least REL): the rounding
# yardstick of DIST in chip_smoke.py, sampled many times, since one draw in a
# few flips a ReLU gate that lies within rounding of 0 (multitask's: a single
# gate moves one channel of two BatchNorm biases by 0.86% of the tensor's
# largest value, in the world of 2 and in such a draw alike). The port's
# world of 2 and world of 1 agree with nkbx's mesh step on this combination
# (NKBX_CASES["multitask"]).
YARDSTICK = ("multitask",)
YARD_DRAWS = 32
ULP = 2.0 ** -23


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(group, out, n=2, local_world=None, extra=(), timeout=240, script=None):
    """Run ``n`` ranks of ``group`` of this file (or of ``script``) and
    return their JSON."""
    port = free_port()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), LOCAL_RANK=str(r % (local_world or n)),
                   LOCAL_WORLD_SIZE=str(local_world or n), OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, str(script or __file__), group, str(out),
                                       *extra],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, cwd=ROOT))
    outs = [p.communicate(timeout=timeout) for p in procs]
    for r, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}\nSTDOUT:{stdout[-3000:]}\nSTDERR:{stderr[-5000:]}"
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(n)]


# --- the ranks ---------------------------------------------------------------------------


def _batches(seed, steps=STEPS, pad_last=0, multi=False):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (steps, B, S, S, 3), dtype=np.uint8)
    masks = np.ones((steps, B), bool)
    if pad_last:
        masks[-1, B - pad_last:] = False
        images[-1, B - pad_last:] = 0  # the loader's padded rows
    if multi:
        labels = {"color": rng.integers(0, 3, (steps, B)), "size": rng.integers(0, 2, (steps, B))}
        labels["size"][:, ::3] = -100  # focal's ignored rows
    else:
        labels = rng.integers(0, 3, (steps, B))
    return images, labels, masks


SCENARIOS = {
    "exact": {},
    "masked": {"masked_bn": True, "pad_last": 3,
               "criterion": {"type": "CrossEntropyLoss", "weight": [1.0, 2.0, 0.5]}},
    "ghost": {"net": "ghost"},
    "cutmix": {"masked_bn": True, "pad_last": 3, "mixup": {"cutmix_alpha": 1.0}},
    "mixup": {"masked_bn": True, "pad_last": 3,
              "mixup": {"alpha": 0.4, "cutmix_alpha": 1.0, "switch_prob": 0.0},
              "criterion": {"type": "CrossEntropyLoss", "label_smoothing": 0.1}},
    "randaugment": {"augment": "randaugment"},
    "accum": {"grad_accum_steps": 2, "pad_last": 3, "masked_bn": True},
    "scan": {"scan_steps": 2},
    "ema": {"ema": True},
    "log_gradients": {"log_gradients": True},
    "multitask": {"multi": True, "masked_bn": True, "pad_last": 2,
                  "criterion": {"task": "multi", "type": "FocalLoss"}},
    "dropout": {"dropout": 0.1},
    "dropout_accum": {"dropout": 0.1, "grad_accum_steps": 2, "pad_last": 3, "masked_bn": True},
}
DROPOUT = ("dropout", "dropout_accum")


def _model(sc):
    import torch

    from nkbx_torch.models import get_model
    from nkbx_torch.models import resnet as R
    from nkbx_torch.models.classifier import ClassificationModel, SingletaskClassifier

    if sc.get("net") == "ghost":  # ghost BN, the identity blocks through the fused chain
        torch.manual_seed(0)
        module = SingletaskClassifier(R.ResNet(stage_sizes=(2,), block_cls=R.Bottleneck,
                                               stem_width=8, ghost_bn=2, fused_bottleneck=True,
                                               dtype=torch.float32), 3)
        return ClassificationModel(module, list("abc"), "single", module.backbone.num_features,
                                   (S, S), torch.float32, torch.device("cpu"))
    classes = {"color": list("rgb"), "size": ["s", "l"]} if sc.get("multi") else list("abc")
    cfg = {"task": "multi" if sc.get("multi") else "single", "model": "resnet_tiny_test"}
    if sc.get("dropout"):
        cfg.update(classifier_dropout=sc["dropout"], backbone_dropout=sc["dropout"])
    return get_model(cfg, classes, input_size=(S, S), seed=0, dtype=torch.float32, device="cpu")


def _flat(tree, prefix=""):
    """{path: numpy array} of the nested dicts and lists of epoch results."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree, key=str) for k, v in
                _flat(tree[key], f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def _run(sc, mesh, seed, perturb=None):
    """Losses, state dicts, EMA state, gradient norms and the epoch results
    of an exact and a bounded EpochCollector of a scenario's steps: the
    global batch in a world of 1 (``mesh`` None), this rank's rows under
    ``mesh``. ``perturb`` (a seed): the normalised input times 1 + ulp·N(0, 1),
    for the rounding yardstick."""
    import torch

    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
    from nkbx_torch.train.engine import EpochCollector
    from nkbx_torch.transforms import spec as T

    model = _model(sc)
    state = TrainState.create(model, seed=0, ema=sc.get("ema", False))
    ops = [T.Normalize()]
    if sc.get("augment") == "randaugment":
        ops = [T.HorizontalFlip(), T.RandAugment(num_ops=2, magnitude=9), T.Normalize()]
    crit = sc.get("criterion", {"type": "CrossEntropyLoss"})
    augment = T.Compose(ops).device_apply
    if perturb is not None:
        stage, noise = augment, torch.Generator().manual_seed(perturb)

        def augment(image, out_dtype=None, generator=None):
            x = stage(image, out_dtype=torch.float32, generator=generator)
            return (x * (1 + ULP * torch.randn(x.shape, generator=noise))).to(out_dtype)

    step = build_train_step(model, get_loss(crit), get_optimizer(SGD), augment_fn=augment,
                            masked_bn=sc.get("masked_bn", False), mixup=sc.get("mixup"),
                            grad_accum_steps=sc.get("grad_accum_steps", 1),
                            scan_steps=sc.get("scan_steps", 1),
                            ema_decay=0.9 if sc.get("ema") else 0.0,
                            log_gradients=sc.get("log_gradients", False), mesh=mesh)
    k = sc.get("scan_steps", 1)
    images, labels, masks = _batches(seed, STEPS + (k > 1), sc.get("pad_last", 0),
                                     sc.get("multi", False))
    rows = mesh.rows(B // mesh.data) if mesh is not None else slice(None)

    def cut(v, i):  # call i's rows: (K, b, ...) under scan_steps, else (b, ...)
        v = v[i:i + k][:, rows] if k > 1 else v[i][rows]
        return torch.from_numpy(np.ascontiguousarray(v))

    task = "multi" if sc.get("multi") else "single"
    # the bounded counts index by label: the multi-task scenario's ignored -100 rows have none
    modes = ("exact",) if sc.get("multi") else ("exact", "bounded")
    collectors = {mode: EpochCollector(task, mode, mesh) for mode in modes}
    losses, norms = [], []
    for i in range(0, len(images), k):
        lab = ({t: cut(v, i) for t, v in labels.items()} if isinstance(labels, dict)
               else cut(labels, i))
        state, m = step(state, cut(images, i), lab, cut(masks, i), 1.0, 1.0)
        for c in collectors.values():
            c.log_iter(m)
        losses.extend(np.ravel(m["loss"].numpy()).tolist())
        if "grad_norms" in m:
            norms.append({key: float(v) for key, v in m["grad_norms"].items()})
    epoch = {}
    for mode, c in collectors.items():
        res = c.get_epoch_results()
        keep = (("running_loss", "confusion_counts") if mode == "bounded" else
                ("running_loss", "confidences", "predictions", "ground_truth"))
        epoch.update(_flat({key: res[key] for key in keep}, mode))
    sd = {k_: v.detach().numpy().copy() for k_, v in model.module.state_dict().items()}
    ema = ({k_: v.detach().numpy().copy() for k_, v in state.ema_module.state_dict().items()}
           if state.ema_module is not None else {})
    return losses, sd, ema, norms, epoch


def _worst(got: dict, want: dict):
    """(largest difference over the tensor's largest value, its key)."""
    worst = (0.0, "")
    for key, w in want.items():
        w = np.asarray(w, np.float64)
        d = np.abs(np.asarray(got[key], np.float64) - w).max() / max(np.abs(w).max(), 1e-30)
        worst = max(worst, (float(d), key))
    return worst


def _collectives_case(rank, n):
    """Every function of the collectives module on CPU tensors, against the
    sums worked out here."""
    import torch

    from nkbx_torch.parallel import collectives as C

    out = {}
    t = torch.arange(4, dtype=torch.float32) + rank
    out["all_reduce"] = C.all_reduce_(t.clone()).tolist()
    out["all_reduce_max"] = C.all_reduce_(t.clone(), op="max").tolist()
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.full((3,), float(rank + 1))
    q = torch.nn.Parameter(torch.zeros(2, dtype=torch.bfloat16))
    q.grad = torch.full((2,), 0.5 * (rank + 1), dtype=torch.bfloat16)
    C.all_reduce_grads([p, q])
    out["grads"] = [p.grad.tolist(), q.grad.float().tolist(), str(q.grad.dtype)]
    out["gather_rows"] = C.all_gather_rows(torch.full((2, 2), rank)).tolist()
    out["gather_bool"] = C.all_gather_rows(torch.tensor([rank == 0, True])).tolist()
    out["gather_object"] = C.all_gather_object({"rank": rank})
    out["broadcast"] = C.broadcast_object(f"from {rank}")
    out["sum_count"] = C.sum_count(rank + 2)
    out["agreed_one"] = C.agreed_any(rank == 1)
    out["agreed_none"] = C.agreed_any(False)
    C.barrier()
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    y = C.sum_across_ranks(x * x)
    (y * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    out["bn_sum"] = y.tolist()
    out["bn_sum_grad"] = x.grad.tolist()
    return out


def _refusals(mesh):
    """The messages of what a rank refuses."""
    import torch

    from nkbx_torch.data.loader import DataLoader
    from nkbx_torch.parallel import make_mesh

    out = {}
    for name, fn in (("data", lambda: make_mesh(n_data=3)),
                     ("model", lambda: make_mesh(n_data=2, n_model=2)),
                     ("split", lambda: DataLoader(list(range(10)), batch_size=5,
                                                  local_rank=mesh.local_rank,
                                                  local_world=mesh.local_world,
                                                  image_size=(4, 4)))):
        try:
            fn()
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    try:  # ghost BN whose groups do not divide a rank's rows
        from nkbx_torch.models.common import TorchBatchNorm
        from nkbx_torch.parallel import collectives

        with collectives.data_parallel(mesh):
            TorchBatchNorm(4, ghost_bn=4).train()(torch.zeros(2, 3, 3, 4))
        out["ghost"] = None
    except ValueError as e:
        out["ghost"] = str(e)
    return out


def rank_step(out_dir):
    from nkbx_torch.core.runtime import initialize
    from nkbx_torch.parallel import make_mesh

    info = initialize(distributed=True, device="cpu")
    mesh = make_mesh()
    res = {"info": {k: str(v) for k, v in info.items()},
           "collectives": _collectives_case(mesh.rank, mesh.data),
           "refusals": _refusals(mesh), "scenarios": {}}
    for i, (name, sc) in enumerate(SCENARIOS.items()):
        l1, sd1, ema1, gn1, ep1 = _run(sc, None, seed=10 + i)
        l2, sd2, ema2, gn2, ep2 = _run(sc, mesh, seed=10 + i)
        params = {k for k in sd1 if "running" not in k and "num_batches" not in k}
        r = {"losses": [l1, l2],
             "params": _worst({k: sd2[k] for k in params}, {k: sd1[k] for k in params}),
             "stats": _worst({k: sd2[k] for k in sd1 if k not in params},
                             {k: sd1[k] for k in sd1 if k not in params}),
             "digest": hashlib.sha256(b"".join(sd2[k].tobytes() for k in sorted(sd2)))
             .hexdigest()}
        if ema1:
            r["ema"] = _worst(ema2, ema1)
        # the epoch's results, gathered in the global row order: integers
        # equal, floats (confidences, losses) within 1e-5 of their largest
        r["epoch_int_equal"] = all(np.array_equal(ep2[key], v) for key, v in ep1.items()
                                   if v.dtype.kind in "iub") and ep1.keys() == ep2.keys()
        r["epoch"] = _worst({key: v for key, v in ep2.items() if v.dtype.kind == "f"},
                            {key: v for key, v in ep1.items() if v.dtype.kind == "f"})
        r["epoch_rows"] = int(sum(v.size for key, v in ep1.items() if "/predictions" in key))
        if gn1:
            r["grad_norms"] = max(_worst(b, a) for a, b in zip(gn1, gn2))
            r["n_norms"] = [len(gn1), len(gn1[0])]
        if name in YARDSTICK and mesh.data > 1:
            draws = [_run(sc, None, seed=10 + i, perturb=d)[1] for d in range(YARD_DRAWS)]
            r["yardstick"] = {
                "params": max(_worst({k: q[k] for k in params}, {k: sd1[k] for k in params})
                              for q in draws),
                "stats": max(_worst({k: q[k] for k in sd1 if k not in params},
                                    {k: sd1[k] for k in sd1 if k not in params})
                             for q in draws)}
        res["scenarios"][name] = r
    (Path(out_dir) / f"rank{mesh.rank}.json").write_text(json.dumps(res))


NKBX_CASES = {"exact": {"masked_bn": False}, "masked": {"masked_bn": True},
              # multi-task focal loss with ignored (-100) labels, masked BatchNorm and 2
              # padded rows in the last step: the step scenario ``multitask``'s combination
              "multitask": {"masked_bn": True, "multi": True}}
MULTI_CLASSES = {"color": list("rgb"), "size": ["s", "l"]}
MULTI_LOSS = {"task": "multi", "type": "FocalLoss"}


def _nkbx_case_inputs(saved, case):
    """(images (STEPS, B, ...), labels (STEPS, B) or {target: (STEPS, B)},
    masks (STEPS, B)) of an NKBX_CASES case from the saved inputs."""
    if NKBX_CASES[case].get("multi"):
        d = saved["multi"]
        return d["images"], d["labels"], d["masks"]
    mask = saved["mask"] if NKBX_CASES[case]["masked_bn"] else np.ones(B, bool)
    return saved["images"], saved["labels"], np.broadcast_to(mask, (STEPS, B))


def rank_nkbx(out_dir, data):
    """The port's world-of-2 steps from the variables and batches the test
    saved, for each case of NKBX_CASES; rank 0 also runs the world of 1 (the
    global batch without the mesh) of each case."""
    import torch

    from nkbx_torch.core.runtime import initialize
    from nkbx_torch.models import get_model
    from nkbx_torch.parallel import make_mesh
    from nkbx_torch.train import TrainState, build_train_step, get_loss, get_optimizer
    from nkbx_torch.transforms import spec as T

    initialize(distributed=True, device="cpu")
    mesh = make_mesh()
    saved = torch.load(Path(data) / "inputs.pt", weights_only=False)
    res = {}
    for case, opts in NKBX_CASES.items():
        multi = opts.get("multi", False)
        images, labels, masks = _nkbx_case_inputs(saved, case)
        for world in ((2, 1) if mesh.rank == 0 else (2,)):
            model = get_model({"task": "multi" if multi else "single",
                               "model": "resnet_tiny_test"},
                              MULTI_CLASSES if multi else list("abc"), input_size=(S, S),
                              dtype=torch.float32, device="cpu")
            model.module.load_state_dict(saved["multi"]["state_dict"] if multi
                                         else saved["state_dict"])
            state = TrainState.create(model)
            step = build_train_step(model, get_loss(MULTI_LOSS if multi
                                                    else {"type": "CrossEntropyLoss"}),
                                    get_optimizer(SGD),
                                    augment_fn=T.Compose([T.Normalize()]).device_apply,
                                    masked_bn=opts["masked_bn"],
                                    mesh=mesh if world == 2 else None)
            rows = mesh.rows(B // 2) if world == 2 else slice(None)

            def cut(v, i):
                return torch.from_numpy(np.ascontiguousarray(v[i][rows]))

            losses = []
            for i in range(STEPS):
                lab = ({t: cut(v, i) for t, v in labels.items()} if multi else cut(labels, i))
                state, m = step(state, cut(images, i), lab, cut(masks, i), 1.0, 1.0)
                losses.append(float(m["loss"]))
            name = f"{case}{mesh.rank}.pt" if world == 2 else f"{case}_world1.pt"
            torch.save({"losses": losses, "state_dict": model.module.state_dict()},
                       Path(out_dir) / name)
    (Path(out_dir) / f"rank{mesh.rank}.json").write_text(json.dumps({"ok": True}))


def rank_nodes(out_dir, n_items):
    """This rank's sample indices of two epochs of a loader over a mesh."""
    from nkbx_torch.core.runtime import initialize
    from nkbx_torch.data.loader import DataLoader, _process_geometry
    from nkbx_torch.parallel import make_mesh

    initialize(distributed=True, device="cpu")
    mesh = make_mesh()

    class Items:  # a dataset whose image is its index
        def __len__(self):
            return int(n_items)

        def read(self, idx, rng=None):
            return np.full((2, 2, 3), idx, np.uint8), idx

    loader = DataLoader(Items(), batch_size=4, shuffle=True, seed=3, num_workers=1,
                        image_size=(2, 2), **_process_geometry(mesh))
    epochs = []
    for e in range(2):
        epochs.append([{"index": b["image"][:, 0, 0, 0].tolist(), "mask": b["mask"].tolist(),
                        "label": b["label"].tolist()} for b in loader.epoch(e)])
    geo = {"node_rank": mesh.node_rank, "node_count": mesh.node_count, "len": len(loader),
           "local_batch": loader.local_batch_size}
    (Path(out_dir) / f"rank{mesh.rank}.json").write_text(json.dumps({"epochs": epochs,
                                                                       "geometry": geo}))


# --- the tests ---------------------------------------------------------------------------


def _close(a, b):
    return abs(a - b) <= REL * max(abs(b), 1e-30)


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    return spawn("step", tmp_path_factory.mktemp("step"))


def test_world_of_two_steps_equal_a_world_of_one(step_runs):
    runs = step_runs
    assert runs[0]["info"]["backend"] == "gloo" and runs[0]["info"]["devices"] == "2"
    for name in SCENARIOS:
        a, b = runs[0]["scenarios"][name], runs[1]["scenarios"][name]
        assert a["digest"] == b["digest"], name  # every rank holds the same parameters
        l1, l2 = a["losses"]
        assert len(l1) == len(l2) and all(_close(x, y) for x, y in zip(l2, l1)), (name, l1, l2)
        assert b["losses"][1] == l2, name  # the global loss on every rank
        yard = a.get("yardstick", {})
        assert (name in YARDSTICK) == bool(yard), name
        for key in ("params", "stats", "ema", "grad_norms", "epoch"):
            if key in a:
                bound = max(REL, 2 * yard[key][0]) if key in yard else REL
                assert a[key][0] <= bound, (name, key, a[key], yard.get(key))
        assert a["epoch_int_equal"] and a["epoch_rows"] > 0, name
    assert runs[0]["scenarios"]["log_gradients"]["n_norms"][1] > 10
    assert "ema" in runs[0]["scenarios"]["ema"]


def test_world_of_two_with_dropout_equals_a_world_of_one(step_runs):
    """``classifier_dropout`` and ``backbone_dropout`` at 0.1, alone and
    with ``grad_accum_steps=2``: each rank draws every mask for the global
    batch (each microbatch's, after accumulation's exchange of rows) from
    the state's generator and keeps its rows, so the world of 2 takes the
    steps of the world of 1 within the scenarios' 1e-5."""
    for name in DROPOUT:
        a, b = step_runs[0]["scenarios"][name], step_runs[1]["scenarios"][name]
        assert a["digest"] == b["digest"], name
        l1, l2 = a["losses"]
        assert len(l1) == len(l2) and all(_close(x, y) for x, y in zip(l2, l1)), (name, l1, l2)
        for key in ("params", "stats", "epoch"):
            assert a[key][0] <= REL, (name, key, a[key])


def test_a_group_of_one_rank_equals_no_group(tmp_path):
    """In a process group of one rank the step runs every collective (so
    that a world of one measures their cost) and still trains the model of
    the step without a group."""
    (run,) = spawn("step", tmp_path, n=1)
    assert run["info"]["devices"] == "1"
    for name, r in run["scenarios"].items():
        l1, l2 = r["losses"]
        assert all(_close(x, y) for x, y in zip(l2, l1)), (name, l1, l2)
        for key in ("params", "stats", "ema", "grad_norms"):
            if key in r:
                assert r[key][0] <= REL, (name, key, r[key])


def test_collectives_and_refusals_on_the_cpu(step_runs):
    """Every function of the collectives module on two gloo ranks, and what a
    rank refuses: a mesh of another size, a model axis (A10b), a batch that
    does not split over the node's ranks, ghost groups larger than a rank's
    rows."""
    for r, run in enumerate(step_runs):
        c = run["collectives"]
        assert c["all_reduce"] == [1.0, 3.0, 5.0, 7.0]
        assert c["all_reduce_max"] == [1.0, 2.0, 3.0, 4.0]
        assert c["grads"] == [[3.0, 3.0, 3.0], [1.5, 1.5], "torch.bfloat16"]
        assert c["gather_rows"] == [[0, 0], [0, 0], [1, 1], [1, 1]]
        assert c["gather_bool"] == [True, True, False, True]
        assert c["gather_object"] == [{"rank": 0}, {"rank": 1}]
        assert c["broadcast"] == "from 0" and c["sum_count"] == 5
        assert c["agreed_one"] is True and c["agreed_none"] is False
        assert c["bn_sum"] == [5.0, 5.0, 5.0]  # 1 + 4
        # d/dx of sum_r (y·w) with y = Σ x²: 2x·Σ_r w over 2 ranks
        assert c["bn_sum_grad"] == [2.0 * (r + 1) * 2 * w for w in (1.0, 2.0, 3.0)]
        ref = run["refusals"]
        assert "ValueError" in ref["data"] and "3" in ref["data"] and "2" in ref["data"]
        assert "NotImplementedError" in ref["model"] and "A10b" in ref["model"]
        assert "ValueError" in ref["split"] and "batch_size 5" in ref["split"]
        assert "ndev*ghost_bn=8" in ref["ghost"] and "B=4" in ref["ghost"]


def test_port_world_of_two_equals_nkbx_mesh_step(tmp_path):
    """nkbx's step under make_mesh(n_data=2) (8 virtual CPU devices), state
    replicated and batch sharded, against the port's 2 ranks and the port's
    world of 1: single-task CE with exact and masked BatchNorm, and a
    multi-task focal loss with ignored labels, masked BatchNorm and padded
    rows in the last step."""
    import jax
    import jax.numpy as jnp
    import torch

    from nkbx.models import get_model as jget_model
    from nkbx.parallel import make_mesh, replicated_sharding, shard_batch
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
    mask[-3:] = False  # rank 1 holds one valid row
    images[:, -3:] = 0
    # the multi-task case: 2 padded rows in the last step, focal's ignored rows
    m_images = rng.integers(0, 256, (STEPS, B, S, S, 3), dtype=np.uint8)
    m_masks = np.ones((STEPS, B), bool)
    m_masks[-1, -2:] = False
    m_images[-1, -2:] = 0
    m_labels = {"color": rng.integers(0, 3, (STEPS, B)).astype(np.int64),
                "size": rng.integers(0, 2, (STEPS, B)).astype(np.int64)}
    m_labels["size"][:, ::3] = -100
    jmodels = {False: jget_model({"task": "single", "model": "resnet_tiny_test"}, list("abc"),
                                 input_size=(S, S), dtype=jnp.float32),
               True: jget_model({"task": "multi", "model": "resnet_tiny_test"}, MULTI_CLASSES,
                                input_size=(S, S), dtype=jnp.float32)}
    variables = {k: jax.device_get(m.variables) for k, m in jmodels.items()}
    data = tmp_path / "data"
    data.mkdir()
    saved = {"state_dict": from_jax_variables(variables[False]), "images": images,
             "labels": labels, "mask": mask,
             "multi": {"state_dict": from_jax_variables(variables[True]), "images": m_images,
                       "labels": m_labels, "masks": m_masks}}
    torch.save(saved, data / "inputs.pt")
    spawn("nkbx", tmp_path / "port", extra=(str(data),))
    mesh = make_mesh(n_data=2)
    for case, opts in NKBX_CASES.items():
        multi = opts.get("multi", False)
        jmodel, var = jmodels[multi], variables[multi]
        bundle = jopt(jmodel.params, SGD)
        step = jstep(jmodel, jloss(MULTI_LOSS if multi else {"type": "CrossEntropyLoss"}),
                     bundle, augment_fn=jspec.Compose([jspec.Normalize()]).device_apply,
                     masked_bn=opts["masked_bn"])
        state = JState.create(var["params"], var["batch_stats"], bundle.tx)
        state = jax.device_put(state, replicated_sharding(mesh))
        c_images, c_labels, c_masks = _nkbx_case_inputs(saved, case)
        losses = []
        for i in range(STEPS):
            lab = {t: v[i] for t, v in c_labels.items()} if multi else c_labels[i]
            batch = shard_batch(mesh, {"image": c_images[i], "label": lab, "mask": c_masks[i]})
            state, metrics = step(state, batch["image"], batch["label"], batch["mask"],
                                  jax.random.PRNGKey(0), jnp.asarray(1.0, jnp.float32),
                                  jnp.asarray(1.0, jnp.float32))
            losses.append(float(metrics["loss"]))
        want = from_jax_variables(jax.device_get({"params": state.params,
                                                  "batch_stats": state.batch_stats}))
        for run in ("0", "1", "_world1"):
            got = torch.load(tmp_path / "port" / f"{case}{run}.pt")
            assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got["losses"], losses)), (
                case, run, got["losses"], losses)
            for key, w in want.items():
                g, w = got["state_dict"][key].numpy(), w.numpy()
                err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
                assert err <= 2e-5, (case, run, key, err)


def _nkbx_slices(n_items, epoch, pi, pc):
    """nkbx's loader indices of process ``pi`` of ``pc`` (loader.py:122-136)."""
    from nkbx.data.sampler import ShuffleSampler

    idx = ShuffleSampler(n_items, seed=3).indices(epoch)
    rem = len(idx) % pc
    if rem:
        idx = np.concatenate([idx, np.full(pc - rem, -1, dtype=idx.dtype)])
    return idx[pi::pc]


def test_two_nodes_read_nkbx_process_slices(tmp_path):
    n_items = 13
    runs = spawn("nodes", tmp_path / "nodes", local_world=1, extra=(str(n_items),))
    for r, run in enumerate(runs):
        assert run["geometry"] == {"node_rank": r, "node_count": 2, "len": 2, "local_batch": 4}
        for e, batches in enumerate(run["epochs"]):
            idx = _nkbx_slices(n_items, e, r, 2)
            got = [i for b in batches for i, v in zip(b["index"], b["mask"]) if v]
            assert got == [int(i) for i in idx if i >= 0]
            assert [v for b in batches for v in b["mask"]] == [
                bool(i >= 0) for i in idx] + [False] * (8 - len(idx))
    # one node of two ranks: each takes its 2 rows of every node batch of 4
    runs = spawn("nodes", tmp_path / "one_node", extra=(str(n_items),))
    for e in range(2):
        idx = _nkbx_slices(n_items, e, 0, 1)
        both = [[i for b in run["epochs"][e] for i, v in zip(b["index"], b["mask"]) if v]
                for run in runs]
        node = [int(i) for i in idx]
        assert both[0] == [i for k in range(0, 16, 4) for i in node[k:k + 2]]
        assert both[1] == [i for k in range(0, 16, 4) for i in node[k + 2:k + 4]]
    assert [run["geometry"]["local_batch"] for run in runs] == [2, 2]


if __name__ == "__main__":
    import torch.distributed as dist

    group, out = sys.argv[1], sys.argv[2]
    {"step": lambda: rank_step(out), "nkbx": lambda: rank_nkbx(out, sys.argv[3]),
     "nodes": lambda: rank_nodes(out, sys.argv[3])}[group]()
    dist.barrier()
    dist.destroy_process_group()
