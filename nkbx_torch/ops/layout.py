"""The Swin layout probes: copies and permutations, the CUDA kernels X3-X7
and their plain PyTorch versions. Counterpart of
``experiments/r3_layout_tax.py`` (X3, X4), ``r3_map_attention_probe.py``
(X5, X6) and ``r3_map_attention_probe2.py`` (X7), forward-only probes of
nkbx's at swin_tiny's shapes, not a path of its models.

- X3 :func:`stream`: the identity copy of (G, N, C).
- X4 :func:`transpose_in_kernel`: a G-minor (N, C, G) input to (G, N, C).
- X5 :func:`gather_windows`: a (B, 7, 7K, C3) stripe to (B, K, 49, C3)
  windows, ``out[b, t, 7r + c] = in[b, r, 7t + c]``.
- X6 :func:`scatter_windows`: the inverse.
- X7 :func:`merge_windows` (A-C: (B, 7, 7, C3) to (B, 49, C3)),
  :func:`split_windows` (D, the inverse) and :func:`pad8` (E: row r of each
  window row to rows 8r..8r+6 of a zero-filled (B, 56, C3)).

Every wrapper returns a fresh tensor. On CUDA tensors (float32 or
bfloat16) it launches ``csrc/layout.cu`` and counts the launch on its own
``.launches``; on CPU tensors it computes the plain version, which spells
the kernel's index arithmetic out in PyTorch (a source index per output
element or row, then one gather). ``library_*`` are the one PyTorch call
of the same function (``clone``, ``permute(...).contiguous()``, ``F.pad``),
yardsticks that the port calls nowhere else.

``python -m nkbx_torch.ops.layout [--device cpu]`` runs the probes: on the
card, each kernel at the probes' shapes against its plain version and the
library call, timed with a cold L2 against the bytes bound; on the CPU, the
plain versions against the library calls at small shapes.
"""

from __future__ import annotations

import ctypes
import sys

import torch
import torch.nn.functional as F

from nkbx_torch.core.runtime import cold_ms, resolve_device
from nkbx_torch.ops import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"nkbx_layout_copy": [_P, _P, _L, _P],
               "nkbx_layout_transpose": [_P, _P, _L, _L, _I, _P],
               "nkbx_layout_rows": [_P, _P, _I, _L, _I, _I, _L, _P]}
_GATHER, _SCATTER, _PAD8 = 0, 1, 2  # layout.cu's row modes
WIN = 7  # the window side of the probes (N = 49 tokens a window)

# swin_tiny @224, batch 64: (G = batch * windows, N, C = 3 * dim), r3_layout_tax.py:42-47
STAGES = [
    ("stage1", 4096, 49, 288),
    ("stage2", 1024, 49, 576),
    ("stage3", 256, 49, 1152),
    ("stage4", 64, 49, 2304),
]
STRIPES, K, C3 = 512, 8, 288  # X5/X6: 512 stripes of K windows, r3_map_attention_probe.py:33-37,59
X7_BLOCKS = 512  # X7: 512 (7, 7, C3) blocks, r3_map_attention_probe2.py:55
ITERS = 20


# --- plain versions: the kernels' index arithmetic, one gather each --------------------


def reference_copy(x):
    """Plain version of X3 and X7 A-D: a fresh tensor with x's bytes."""
    return torch.empty_like(x, memory_format=torch.contiguous_format).copy_(x)


def reference_transpose(xt):
    """Plain version of X4: out[g, n, c] = xt[n, c, g], gathered through the
    flat source index (n·C + c)·G + g of each output element."""
    n, c, g = xt.shape
    r = n * c
    src = (torch.arange(r, device=xt.device) * g).view(1, r) + torch.arange(
        g, device=xt.device).view(g, 1)
    return xt.reshape(-1)[src.reshape(-1)].view(g, n, c)


def source_rows(mode, blocks, k, device, win=WIN):
    """layout.cu's ``source_row`` for every output row: the input row each
    reads, -1 for a zero row (pad8)."""
    nw = win * win
    if mode == _PAD8:
        i = torch.arange(blocks * (nw + win), device=device)
        b, j = i // (nw + win), i % (nw + win)
        r, c = j // (win + 1), j % (win + 1)
        return torch.where(c == win, -1, b * nw + r * win + c)
    per = nw * k
    i = torch.arange(blocks * per, device=device)
    b, j = i // per, i % per
    if mode == _GATHER:  # j = (t, win*r + c), the input stripe row (r, win*t + c)
        t, rc = j // nw, j % nw
        return b * per + (rc // win) * win * k + win * t + rc % win
    r, tc = j // (win * k), j % (win * k)  # scatter: j = (r, win*t + c)
    return b * per + (tc // win) * nw + win * r + tc % win


def _gather_rows(x, mode, blocks, k, out_shape):
    rows = x.reshape(-1, x.shape[-1])
    if mode == _PAD8:  # index -1 reads the appended zero row
        rows = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
    return rows[source_rows(mode, blocks, k, x.device)].view(out_shape)


def reference_gather_windows(x):
    """Plain version of X5: (B, 7, 7K, C3) -> (B, K, 49, C3)."""
    b, _, wk, c = x.shape
    return _gather_rows(x, _GATHER, b, wk // WIN, (b, wk // WIN, WIN * WIN, c))


def reference_scatter_windows(x):
    """Plain version of X6: (B, K, 49, C3) -> (B, 7, 7K, C3)."""
    b, k, _, c = x.shape
    return _gather_rows(x, _SCATTER, b, k, (b, WIN, WIN * k, c))


def reference_merge_windows(x):
    """Plain version of X7 A-C: (B, 7, 7, C3) -> (B, 49, C3), a copy."""
    return reference_copy(x).view(x.shape[0], WIN * WIN, x.shape[-1])


def reference_split_windows(x):
    """Plain version of X7 D: (B, 49, C3) -> (B, 7, 7, C3), a copy."""
    return reference_copy(x).view(x.shape[0], WIN, WIN, x.shape[-1])


def reference_pad8(x):
    """Plain version of X7 E: (B, 7, 7, C3) -> (B, 56, C3), zero rows 8r + 7."""
    b, c = x.shape[0], x.shape[-1]
    return _gather_rows(x, _PAD8, b, 1, (b, WIN * (WIN + 1), c))


# --- the library's one call of each function (yardsticks, timed only) ------------------


def library_copy(x):
    return x.clone()


def library_transpose(xt):
    return xt.permute(2, 0, 1).contiguous()


def library_gather_windows(x):
    b, _, wk, c = x.shape
    k = wk // WIN
    return x.view(b, WIN, k, WIN, c).permute(0, 2, 1, 3, 4).reshape(b, k, WIN * WIN, c)


def library_scatter_windows(x):
    b, k, _, c = x.shape
    return x.view(b, k, WIN, WIN, c).permute(0, 2, 1, 3, 4).reshape(b, WIN, WIN * k, c)


def library_merge_windows(x):
    return x.reshape(x.shape[0], WIN * WIN, x.shape[-1]).clone()


def library_split_windows(x):
    return x.reshape(x.shape[0], WIN, WIN, x.shape[-1]).clone()


def library_pad8(x):
    """F.pad of the (B, 7, 7, C3) view: one call plus a free reshape."""
    return F.pad(x, (0, 0, 0, 1)).reshape(x.shape[0], WIN * (WIN + 1), x.shape[-1])


# --- the kernels ----------------------------------------------------------------------


def _prepare(x, what):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"{what} kernel needs a non-empty tensor")
    return _build.load("layout", _SIGNATURES), x.contiguous()


def _stream_of(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _copy(x, shape, what):
    lib, x = _prepare(x, what)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.nkbx_layout_copy(x.data_ptr(), out.data_ptr(), x.numel() * x.element_size(),
                                   _stream_of(x))
    _build.check(err, f"{what} launch")
    return out


def _rows(x, mode, blocks, k, shape, what):
    lib, x = _prepare(x, what)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.nkbx_layout_rows(x.data_ptr(), out.data_ptr(), mode, blocks, WIN, k,
                                   x.shape[-1] * x.element_size(), _stream_of(x))
    _build.check(err, f"{what} launch")
    return out


def _expect(x, ndim, what, sizes=None, multiple=None):
    """Raise unless x has ``ndim`` dims, ``x.shape[d] == n`` for each
    ``{d: n}`` of ``sizes``, and ``x.shape[d] % n == 0`` for ``multiple``
    ``(d, n)``."""
    if x.dim() != ndim:
        raise ValueError(f"{what}: expected a {ndim}-d tensor, got {tuple(x.shape)}")
    for d, n in (sizes or {}).items():
        if x.shape[d] != n:
            raise ValueError(f"{what}: dim {d} of {tuple(x.shape)} must be {n}")
    if multiple is not None and x.shape[multiple[0]] % multiple[1]:
        raise ValueError(f"{what}: dim {multiple[0]} of {tuple(x.shape)} must be a multiple "
                         f"of {multiple[1]}")


def stream(x):
    """X3: a fresh copy of x (any shape)."""
    if not x.is_cuda:
        return reference_copy(x)
    out = _copy(x, x.shape, "stream")
    stream.launches += 1
    return out


def transpose_in_kernel(xt):
    """X4: the G-minor (N, C, G) xt to (G, N, C)."""
    _expect(xt, 3, "transpose_in_kernel")
    if not xt.is_cuda:
        return reference_transpose(xt)
    n, c, g = xt.shape
    lib, xt = _prepare(xt, "transpose_in_kernel")
    out = torch.empty(g, n, c, dtype=xt.dtype, device=xt.device)
    with torch.cuda.device(xt.device):
        err = lib.nkbx_layout_transpose(xt.data_ptr(), out.data_ptr(), n * c, g,
                                        xt.element_size(), _stream_of(xt))
    _build.check(err, "transpose_in_kernel launch")
    transpose_in_kernel.launches += 1
    return out


def gather_windows(x):
    """X5: the (B, 7, 7K, C3) stripes to (B, K, 49, C3) windows."""
    _expect(x, 4, "gather_windows", {1: WIN}, multiple=(2, WIN))
    if not x.is_cuda:
        return reference_gather_windows(x)
    b, _, wk, c = x.shape
    out = _rows(x, _GATHER, b, wk // WIN, (b, wk // WIN, WIN * WIN, c), "gather_windows")
    gather_windows.launches += 1
    return out


def scatter_windows(x):
    """X6: the (B, K, 49, C3) windows to (B, 7, 7K, C3) stripes."""
    _expect(x, 4, "scatter_windows", {2: WIN * WIN})
    if not x.is_cuda:
        return reference_scatter_windows(x)
    b, k, _, c = x.shape
    out = _rows(x, _SCATTER, b, k, (b, WIN, WIN * k, c), "scatter_windows")
    scatter_windows.launches += 1
    return out


def merge_windows(x):
    """X7 A-C: (B, 7, 7, C3) to (B, 49, C3), a copy of the bytes."""
    _expect(x, 4, "merge_windows", {1: WIN, 2: WIN})
    if not x.is_cuda:
        return reference_merge_windows(x)
    out = _copy(x, (x.shape[0], WIN * WIN, x.shape[-1]), "merge_windows")
    merge_windows.launches += 1
    return out


def split_windows(x):
    """X7 D: (B, 49, C3) to (B, 7, 7, C3), a copy of the bytes."""
    _expect(x, 3, "split_windows", {1: WIN * WIN})
    if not x.is_cuda:
        return reference_split_windows(x)
    out = _copy(x, (x.shape[0], WIN, WIN, x.shape[-1]), "split_windows")
    split_windows.launches += 1
    return out


def pad8(x):
    """X7 E: (B, 7, 7, C3) to (B, 56, C3), row r·7 + c to 8r + c and zero
    rows 8r + 7, written by the one kernel."""
    _expect(x, 4, "pad8", {1: WIN, 2: WIN})
    if not x.is_cuda:
        return reference_pad8(x)
    out = _rows(x, _PAD8, x.shape[0], 1, (x.shape[0], WIN * (WIN + 1), x.shape[-1]), "pad8")
    pad8.launches += 1
    return out


for _fn in (stream, transpose_in_kernel, gather_windows, scatter_windows, merge_windows,
            split_windows, pad8):
    _fn.launches = 0  # launches of each wrapper's kernel, counted where it launches


# --- the probes, from the command line -------------------------------------------------


def probe_cases(small=False):
    """(row, name, kernel, plain, library, input shape): every probe shape.
    ``small`` cuts the leading dimension to 2 (and X3/X4's G to 16) for a
    run on the CPU."""
    cases = []
    for name, g, n, c in STAGES:
        g = 16 if small else g
        cases.append(("X3", f"{name} G={g} N={n} C={c}", stream, reference_copy, library_copy,
                      (g, n, c)))
        cases.append(("X4", f"{name} G={g} N={n} C={c}", transpose_in_kernel,
                      reference_transpose, library_transpose, (n, c, g)))
    b = 2 if small else STRIPES
    cases.append(("X5", f"B={b} K={K} C3={C3}", gather_windows, reference_gather_windows,
                  library_gather_windows, (b, WIN, WIN * K, C3)))
    cases.append(("X6", f"B={b} K={K} C3={C3}", scatter_windows, reference_scatter_windows,
                  library_scatter_windows, (b, K, WIN * WIN, C3)))
    b = 2 if small else X7_BLOCKS
    cases.append(("X7", f"A-C merge B={b} C3={C3}", merge_windows,
                  reference_merge_windows, library_merge_windows, (b, WIN, WIN, C3)))
    cases.append(("X7", f"D split B={b} C3={C3}", split_windows,
                  reference_split_windows, library_split_windows, (b, WIN * WIN, C3)))
    cases.append(("X7", f"E pad8 B={b} C3={C3}", pad8, reference_pad8, library_pad8,
                  (b, WIN, WIN, C3)))
    return cases


def work(shape, out_numel, itemsize):
    """Bytes of one call: the input read once and the output written once."""
    n = 1
    for d in shape:
        n *= d
    return itemsize * (n + out_numel)


def inputs(shape, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=device).to(dtype)


def main(iters=ITERS, device=None):
    """Each probe case in bf16: on the card the kernel's output against its
    plain version and the library call (all equal), and the cold-L2 times of
    the three with the bytes bound (launches each kernel ``iters + 2`` times
    a case); on the CPU (``device="cpu"``) the plain versions against the
    library calls at small shapes, untimed. Returns one dict per case."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    print(f"{torch.cuda.get_device_name(dev) if on_card else 'cpu'}: the Swin layout probes, bf16")
    rows = []
    for i, (row, name, fn, plain, library, shape) in enumerate(probe_cases(small=not on_card)):
        x = inputs(shape, torch.bfloat16, dev, seed=i)
        got, want, lib = fn(x), plain(x), library(x)
        equal = torch.equal(got, want) and torch.equal(lib, want)
        r = dict(row=row, case=name, equal=equal, bytes=work(shape, want.numel(), 2))
        if on_card:
            r.update(ms=cold_ms(lambda: fn(x), iters), plain_ms=cold_ms(lambda: plain(x), iters),
                     library_ms=cold_ms(lambda: library(x), iters))
            print(f"{row} {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library {r['library_ms']:.4f} ms, {r['bytes'] / 1e6:.1f} MB, "
                  f"equal {equal}")
        else:
            print(f"{row} {name}: plain equals the library call: {equal}")
        rows.append(r)
        del x, got, want, lib
    return rows


if __name__ == "__main__":
    dev = sys.argv[sys.argv.index("--device") + 1] if "--device" in sys.argv else None
    rows = main(device=dev)
    if not all(r["equal"] for r in rows):
        sys.exit("layout probe: a kernel or plain version disagrees")
