"""One-command reference-config migration: torch/albumentations -> nkbx
(the port's copy of ``nkbx/utils/migrate.py``).

``python -m nkbx_torch.utils.migrate old_config.py -o new_config.py [--check]``

For the same input, :func:`migrate_text` gives the text and the warnings
that nkbx's gives: one nkbx-format config (``import nkbx.transforms as T``),
which nkbx and the port both load (the port's loader resolves
``nkbx.transforms`` to :mod:`nkbx_torch.transforms` while a config runs).
The edits: ``albumentations`` imports and ``A.`` call sites to ``T.``; the
``ToTensorV2`` import dropped; torch imports and torch-only keys
(``device``, ``enable_gradient_scaler``, ``compile``) commented out with the
reason; a pre-dict ``nn.CrossEntropyLoss()`` criterion rewritten as a dict.
Warnings (not edits): a torch checkpoint path, a remaining torch/cuda
reference, an op that the transforms do not have (the names of
:mod:`nkbx_torch.transforms`, which equal nkbx's), a star import, another
``nn`` criterion.

``--check`` loads the result through :func:`nkbx_torch.utils.load_config`
and builds its pipelines.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

HEADER = """\
# Migrated from a nkb-classification (torch) config by `python -m
# nkbx.utils.migrate`. Review lines tagged [nkbx-migrate]; new optional TPU
# knobs (mesh / fsdp / steps_per_dispatch / model_ema_decay / mixup /
# metrics_accumulation) are documented in configs/ and MIGRATING.md.
"""

# config keys that have no meaning under nkbx, commented out with the reason
_DEAD_KEYS = {
    "device": "chips are selected by the `mesh` key (see MIGRATING.md §config)",
    "enable_gradient_scaler": "bf16 training needs no GradScaler",
    "compile": "every nkbx step is jit-compiled already",
}


def _transform_names():
    import nkbx_torch.transforms as T

    return {n for n in dir(T) if not n.startswith("_")}


def migrate_text(src: str):
    """Returns (migrated_text, warnings: list[str])."""
    warnings: list[str] = []
    alias = None
    from_imports: set[str] = set()  # names from `from albumentations import X, Y`
    out_lines = []
    known = _transform_names()

    for lineno, line in enumerate(src.splitlines(), 1):
        stripped = line.strip()

        m = re.match(r"import\s+albumentations\s+as\s+(\w+)\s*$", stripped)
        if m:
            alias = m.group(1)
            out_lines.append("import nkbx.transforms as T  # [nkbx-migrate] was: " + stripped)
            continue
        if re.match(r"import\s+albumentations\s*$", stripped):
            alias = "albumentations"
            out_lines.append("import nkbx.transforms as T  # [nkbx-migrate] was: " + stripped)
            continue
        if re.match(r"from\s+albumentations\.pytorch\s+import\s+ToTensorV2", stripped):
            out_lines.append("# [nkbx-migrate] dropped: " + stripped +
                             "  (T.ToTensorV2 is built in)")
            continue
        m = re.match(r"from\s+albumentations\s+import\s+(.+?)\s*$", stripped)
        if m:
            if "*" in m.group(1):
                warnings.append(
                    f"line {lineno}: 'from albumentations import *' cannot be "
                    f"migrated mechanically — import nkbx.transforms as T and "
                    f"prefix the op names")
                out_lines.append(line)
            else:
                from_imports.update(
                    n.strip() for n in m.group(1).split(",") if n.strip())
                out_lines.append("import nkbx.transforms as T  # [nkbx-migrate] was: "
                                 + stripped)
            continue
        if re.match(r"(import\s+torch(\.\w+)*(\s+as\s+\w+)?|from\s+torch[.\w]*\s+import\s+.*)$",
                    stripped):
            out_lines.append("# [nkbx-migrate] torch import dropped "
                             "(nkbx is torch-free at runtime): " + stripped)
            continue

        # pre-dict-era reference configs: criterion as a torch module instance
        m = re.match(r"criterion\s*=\s*(?:torch\.)?nn\.CrossEntropyLoss\(\s*\)", stripped)
        if m:
            # pre-dict configs predate multitask, so the task is "single"
            out_lines.append('criterion = {"task": "single", "type": "CrossEntropyLoss"}'
                             "  # [nkbx-migrate] was: " + stripped)
            continue
        m = re.match(r"criterion\s*=\s*(?:torch\.)?nn\.(\w+)\(", stripped)
        if m:
            warnings.append(
                f"line {lineno}: criterion uses torch nn.{m.group(1)} — rewrite "
                f"as a dict, e.g. {{'task': task, 'type': 'CrossEntropyLoss'}} "
                f"or {{'type': 'FocalLoss', ...}} (see configs/)")

        dead = next((k for k in _DEAD_KEYS
                     if re.match(rf"{k}\s*=", stripped)), None)
        if dead:
            out_lines.append(f"# [nkbx-migrate] {_DEAD_KEYS[dead]}: {line}")
            continue

        if alias:
            line = re.sub(rf"\b{alias}\.(\w+)", r"T.\1", line)
        for name in from_imports:
            line = re.sub(rf"(?<![\w.]){name}\(", f"T.{name}(", line)
        line = re.sub(r"(?<![\w.])ToTensorV2\(", "T.ToTensorV2(", line)
        out_lines.append(line)

        for op in re.findall(r"\bT\.(\w+)\s*\(", line):
            if op not in known:
                warnings.append(
                    f"line {lineno}: T.{op} is not a nkbx transform — "
                    f"check nkbx.transforms for the equivalent")
        m = re.search(r"checkpoint[\"']?\s*[:=]\s*[\"']([^\"']+\.pth?)[\"']", line)
        if m:
            warnings.append(
                f"line {lineno}: torch checkpoint {m.group(1)!r} — convert it "
                f"first: python -m nkbx.models.convert --model <name> "
                f"--weights {m.group(1)} --reference-checkpoint "
                f"--out model.msgpack, then point `checkpoint` at the .msgpack")
        if re.search(r"\btorch\b|\bcuda\b", line) and "[nkbx-migrate]" not in line:
            warnings.append(f"line {lineno}: torch/cuda reference kept verbatim: "
                            f"{stripped[:70]}")

    return HEADER + "\n".join(out_lines) + "\n", warnings


def check_config(path: Path) -> list[str]:
    """Load the migrated config and instantiate its pipelines."""
    import nkbx_torch.transforms as T
    from nkbx_torch.utils.config import load_config

    problems = []
    cfg = load_config(str(path))
    for key in ("train_pipeline", "val_pipeline", "inference_pipeline"):
        pipe = cfg.get(key, None)
        if pipe is None:
            continue
        if not isinstance(pipe, T.Compose):
            problems.append(f"{key} is {type(pipe).__name__}, expected T.Compose")
    for key in ("criterion", "model", "optimizer"):
        val = cfg.get(key, None)
        if val is not None and not isinstance(val, dict):
            problems.append(f"{key} is {type(val).__name__}, expected a dict "
                            f"(see configs/ for the key surface)")
    return problems


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Migrate a nkb-classification config to nkbx")
    p.add_argument("config", help="reference config .py")
    p.add_argument("-o", "--out", help="output path (default: <name>_nkbx.py)")
    p.add_argument("--check", action="store_true",
                   help="load the migrated config through nkbx to validate")
    args = p.parse_args(argv)

    src_path = Path(args.config)
    out_path = Path(args.out) if args.out else src_path.with_name(
        src_path.stem + "_nkbx.py")
    text, warnings = migrate_text(src_path.read_text())
    out_path.write_text(text)
    print(f"Wrote {out_path}")
    for w in warnings:
        print(f"WARNING: {w}", file=sys.stderr)

    if args.check:
        problems = check_config(out_path)
        for pr in problems:
            print(f"CHECK FAILED: {pr}", file=sys.stderr)
        if problems:
            return 1
        print("check ok: config loads and pipelines instantiate")
    return 0


if __name__ == "__main__":
    sys.exit(main())
