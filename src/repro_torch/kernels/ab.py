"""Time two or more versions of ``csrc/fused_mac.cu`` (or of
``csrc/ota_combine.cu``, or of the flash kernels) against each other on
one card, in turns.

    PYTHONPATH=src python -m repro_torch.kernels.ab OLD.cu NEW.cu

(an older version comes from ``git show <rev>:src/repro_torch/csrc/
fused_mac.cu > OLD.cu``, in a directory the chip copy carries).  Each
source is built with the package's nvcc flags, and each entry point that
every source has is timed with CUDA events at the main path's shapes, in
the order A, B, ..., B, A: `fused_mac` at its hops' shapes,
`fused_mac_partials` at the scale_u65536 1x1 shape, `ota_combine` at its
four main-path shapes, and flash attention (causal) at the prefill
shapes of the main paths in bf16 and float32: qwen2-0.5b's (hd 64; in
bf16 also at prefill_32k's length), qwen2-1.5b's float32 one (hd 128),
the serving example's reduced model (hd 32), hd 16 at the same batch and
length, and zamba2-7b's (hd 112).  A flash source is timed at a dtype
through the first of FLASH_ENTRIES[dtype] it has: the bf16 tensor-core
kernel's (`flash_attn.ARGTYPES`), the tf32 kernel's
(`flash_attn.TF32_ARGTYPES`, with its scratch) or an older source's
CUDA-core ``flash_attn_launch`` (dtype code 0 or 1), so an older
``flash_attn.cu`` can be timed against the tensor-core sources; each
entry point through the signature its source's text declares
(`flash_argtypes`): one that takes a sliding window (``int window``)
runs at window 0, none, and one that takes a query offset (``int
q_offset``) at offset 0, while one from before the window
(`flash_attn.NO_WINDOW_ARGTYPES`) or from before the offset
(`flash_attn.NO_OFFSET_ARGTYPES`) goes without, so a source's new
argument is timed against the kernel it replaced; a source with none of
them, or whose entry point refuses a shape, is left out
there (and listed as refusing it).  Prints one JSON line per shape
(times, and whether each version's output equals the first's bit for
bit, with the largest gap where it does not), one per kernel with its
SASS report (`repro_torch.kernels.sass`), and the card's name and power
limit.  An older source that includes ``hopper_common.cuh`` finds the
header beside it first, so keep the older header with it.  Needs a CUDA
card and nvcc.

    PYTHONPATH=src python -m repro_torch.kernels.ab --edge OLD.cu NEW.cu

times nothing: it runs each flash source once at FLASH_EDGE_CASES (the
smoke's phase-3 shapes at hd 64 and 128: ragged lengths, 128-row tiles
that straddle two heads, both masks, both dtypes) and prints whether
each output equals the first source's bit for bit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import build, flash_attn, sass

# (B, U, K, N, block_u): scale_u256's and scale_u1024's cluster hops and
# scale_u16384's gathered hop on a 1x1 mesh
MAC_SHAPES = [(4, 256, 16, 3925, 64), (8, 1024, 16, 3925, 128),
              (16, 16384, 4, 3925, 1024)]
PARTIALS_SHAPE = (16, 65536, 4, 3925, 1024)     # scale_u65536 1x1
# ((B, L, H, KV, hd), dtype): qwen2-0.5b's prefill (bf16 also at
# prefill_32k's length), qwen2-1.5b's float32 one, the serving example's
# reduced model, hd 16 at its batch and length, and zamba2-7b's (hd 112
# on the hd-128 instances) in both dtypes
FLASH_CASES = [((4, 4096, 14, 2, 64), torch.bfloat16),
               ((1, 32768, 14, 2, 64), torch.bfloat16),
               ((4, 4096, 4, 2, 32), torch.bfloat16),
               ((4, 4096, 4, 2, 16), torch.bfloat16),
               ((4, 4096, 32, 32, 112), torch.bfloat16),
               ((4, 4096, 14, 2, 64), torch.float32),
               ((1, 4096, 12, 2, 128), torch.float32),
               ((4, 4096, 4, 2, 32), torch.float32),
               ((4, 4096, 4, 2, 16), torch.float32),
               ((4, 4096, 32, 32, 112), torch.float32)]
# ((B, L, H, KV, hd), dtype, causal) for --edge: the smoke's phase-3
# shapes at hd 64 and 128, every one in both dtypes and both masks
FLASH_EDGE_CASES = [(shape, dtype, causal)
                    for shape in ((2, 200, 14, 2, 64), (1, 77, 14, 2, 64),
                                  (1, 128, 8, 8, 64), (4, 4096, 14, 2, 64),
                                  (2, 200, 12, 2, 128), (1, 77, 12, 2, 128),
                                  (1, 256, 2, 2, 128), (1, 1000, 12, 2, 128))
                    for dtype in (torch.bfloat16, torch.float32)
                    for causal in (True, False)]
# the flash entry points that take each dtype, in order of preference
FLASH_ENTRIES = {torch.bfloat16: ("flash_attn_wgmma_launch",
                                  "flash_attn_launch"),
                 torch.float32: ("flash_attn_tf32_launch",
                                 "flash_attn_launch")}
# (B, U, K, N): the Fig. 2 driver's cluster, IS->PS and conventional
# hops (the last two unbatched, as B = 1) and scale_u256's cluster hop
OTA_SHAPES = [(4, 20, 100, 3925), (1, 4, 100, 3925), (1, 20, 100, 3925),
              (4, 256, 16, 3925)]
_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)


def flash_argtypes(entry: str, params: str):
    """The ctypes prototype of flash entry point `entry` from its C
    parameter list `params` (the source's text between the parentheses):
    the tf32 kernel's (with its scratch) or the others', with the window
    and the query offset where the list declares them.  Returns
    (argtypes, takes a window, takes q_offset)."""
    windowed = "int window" in params
    offset = "int q_offset" in params
    fa = flash_attn
    table = ({(True, True): fa.TF32_ARGTYPES,
              (True, False): fa.NO_OFFSET_TF32_ARGTYPES,
              (False, False): fa.NO_WINDOW_TF32_ARGTYPES}
             if entry == "flash_attn_tf32_launch" else
             {(True, True): fa.ARGTYPES,
              (True, False): fa.NO_OFFSET_ARGTYPES,
              (False, False): fa.NO_WINDOW_ARGTYPES})
    if (windowed, offset) not in table:
        raise ValueError(f"{entry}: a query offset without a window")
    return table[windowed, offset], windowed, offset


def entry_params(text: str, entry: str) -> str:
    """The C parameter list of `entry` in source `text` ("" where the
    source has no such entry point)."""
    at = text.find(f'"C" int {entry}(')
    return text[at:text.index(")", at)] if at >= 0 else ""


def build_source(src: Path, out_dir: Path):
    """(library, nvcc log, (whether `fused_mac_launch`, where the source
    has it, takes block_u, which launch entry points take a leading seed
    count S and seed strides, and each flash entry point's
    `flash_argtypes`))."""
    lib = out_dir / f"lib{src.stem}_{len(list(out_dir.iterdir()))}.so"
    # -I: an older source from elsewhere finds the package's csrc/ headers
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    text = src.read_text()
    params = lambda entry: entry_params(text, entry)
    takes_block_u = "block_u" in params("fused_mac_launch")
    seeded = {e for e in ("fused_mac_launch", "ota_combine_launch")
              if "int S," in params(e)}
    flash = {e: flash_argtypes(e, params(e))
             for entries in FLASH_ENTRIES.values() for e in entries
             if params(e)}
    return lib, proc.stdout + proc.stderr, (takes_block_u, seeded, flash)


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def inputs(B, U, N, seed, dev):
    g = torch.Generator().manual_seed(seed)
    t_re = (1e-2 * torch.randn(U, N, generator=g)).to(dev)
    t_im = (1e-2 * torch.randn(U, N, generator=g)).to(dev)
    amp = (0.2 + torch.rand(B, U, generator=g)).to(dev)
    return t_re, t_im, amp, torch.ones(B, U, device=dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--edge", action="store_true",
                    help="compare flash outputs at FLASH_EDGE_CASES bit "
                         "for bit, timing nothing")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab: this comparison needs a CUDA card")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    words = torch.tensor([0xC0FFEE, 42, 0, 0, 0, 0, 0, 0],
                         dtype=torch.int32, device=dev)
    names = [f"{i}:{s}" for i, s in enumerate(a.sources)]
    built = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, src in zip(names, a.sources):
            lib, log, entries = build_source(src, Path(tmp))
            dis = sass.disassemble(lib)
            built[name] = (ctypes.CDLL(str(lib)), entries)
            for kernel, rec in sass.analyse(dis, log).items():
                rec.pop("per_draw_by_opcode", None)
                print(json.dumps({"source": name, "kernel": kernel, **rec}),
                      flush=True)
    order = names + names[::-1]
    has = lambda fn: all(hasattr(lib, fn) for lib, _ in built.values())
    if a.edge:
        for shape, dtype, causal in FLASH_EDGE_CASES:
            flash_case(built, shape, dtype, causal, None, dev)
        return card_line()

    for B, U, K, N, bu in MAC_SHAPES if has("fused_mac_launch") else ():
        t_re, t_im, amp, w = inputs(B, U, N, 0, dev)

        def call(name):
            lib, (takes_bu, seeded, _) = built[name]
            fn = lib.fused_mac_launch
            fn.restype = _I
            y = torch.empty(2, B, N, device=dev)
            # one seed; a seeded source also takes the seed strides
            s = "fused_mac_launch" in seeded
            args = [words, t_re, t_im, amp, w, y[0], y[1], *([1] * s), B,
                    U, K, N, *([bu] if takes_bu else []),
                    *([U * N, B * U] * s), 0.70710677, 0.70710677]
            fn.argtypes = [_P] * 7 + [_I] * (4 + takes_bu + s) + \
                [_L] * (2 * s) + [_F] * 2 + [_P]
            err = fn(*[x.data_ptr() if isinstance(x, torch.Tensor) else x
                       for x in args], stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return y

        reps = a.reps if U < 16384 else max(a.reps // 4, 1)
        ms = {n: [] for n in names}
        for n in order:
            ms[n].append(time_ms(lambda: call(n), reps))
        first = call(names[0])
        print(json.dumps({"kernel": "fused_mac", "shape_BUKN": [B, U, K, N],
                          "block_u": bu, "ms": ms, "bitwise_equal_first": {
                              n: torch.equal(call(n), first)
                              for n in names}}), flush=True)

    if has("fused_mac_partials_launch"):
        B, U, K, N, bu = PARTIALS_SHAPE
        t_re, t_im, amp, w = inputs(B, U, N, 1, dev)

        def pcall(name):
            fn = built[name][0].fused_mac_partials_launch
            fn.restype = _I
            fn.argtypes = [_P] * 9 + [_I] * 5 + [_F, _P]
            p = torch.empty(4, B, U // bu, K, N, device=dev)
            err = fn(*[x.data_ptr() for x in (words, t_re, t_im, amp, w,
                                               *p)],
                     B, U, K, N, bu, 0.70710677, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return p

        ms = {n: [] for n in names}
        for n in order:
            ms[n].append(time_ms(lambda: pcall(n), 3))
        first = pcall(names[0])
        print(json.dumps({"kernel": "fused_mac_partials",
                          "shape_BUKN": [B, U, K, N], "block_u": bu,
                          "ms": ms, "bitwise_equal_first": {
                              n: torch.equal(pcall(n), first)
                              for n in names}}), flush=True)
    def compare(kernel, shape_key, shape, fn, reps, versions=None):
        """Time fn(name) for every version (all by default) in turns, and
        print the times and each output against the first version's."""
        versions = versions or names
        ms = {n: [] for n in versions}
        for n in versions + versions[::-1]:
            ms[n].append(time_ms(lambda: fn(n), reps))
        outs = {n: fn(n) for n in versions}
        first = outs[versions[0]]
        print(json.dumps({
            "kernel": kernel, shape_key: list(shape), "ms": ms,
            "bitwise_equal_first": {n: torch.equal(o, first)
                                    for n, o in outs.items()},
            "max_abs_gap_first": {n: float((o.float() - first.float())
                                           .abs().max())
                                  for n, o in outs.items()}}), flush=True)

    for B, U, K, N in OTA_SHAPES if has("ota_combine_launch") else ():
        g = torch.Generator().manual_seed(B + U + K + N)
        cx = lambda *s: torch.randn(*s, dtype=torch.complex64,
                                    generator=g).to(dev)
        h, t, z = cx(B, U, K, N), cx(U, N), cx(B, K, N)
        w = torch.randn(B, U, generator=g).to(dev)

        def ocall(name):
            fn = built[name][0].ota_combine_launch
            s = "ota_combine_launch" in built[name][1][1]
            fn.restype = _I
            fn.argtypes = [_P] * 5 + [_I] * (4 + s) + [_L] * (4 * s) + [_P]
            y = torch.empty(B, N, dtype=torch.complex64, device=dev)
            # one seed; a seeded source also takes the seed strides
            err = fn(*[x.data_ptr() for x in (h, t, z, w, y)],
                     *([1] * s), B, U, K, N,
                     *([B * U * K * N, U * N, B * K * N, B * U] * s),
                     stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return torch.view_as_real(y)

        compare("ota_combine", "shape_BUKN", (B, U, K, N), ocall, a.reps)

    for shape, dtype in FLASH_CASES:
        flash_case(built, shape, dtype, True, compare, dev,
                   reps=a.reps if dtype == torch.bfloat16
                   else max(a.reps // 2, 1),
                   long_reps=max(a.reps // 4, 1))
    return card_line()


def flash_case(built, shape, dtype, causal, compare, dev, reps=0,
               long_reps=0) -> None:
    """One flash shape across the sources that have an entry point for
    `dtype`: with `compare`, timed through it in turns; without, run once
    and printed with each output against the first source's bit for
    bit."""
    B, L, H, KV, hd = shape
    entry = {n: next((e for e in FLASH_ENTRIES[dtype] if hasattr(lib, e)),
                     None)
             for n, (lib, _) in built.items()}
    entry = {n: e for n, e in entry.items() if e}
    if not entry:
        return
    g = torch.Generator().manual_seed(2 if dtype == torch.bfloat16 else 3)
    q, k, v = (torch.randn(*s, generator=g).to(dev, dtype)
               for s in ((B, L, H, hd), (B, L, KV, hd), (B, L, KV, hd)))
    label = f"flash_attn {str(dtype).split('.')[-1]}"

    def flaunch(name):
        tf32 = entry[name] == "flash_attn_tf32_launch"
        argtypes, windowed, offset = built[name][1][2][entry[name]]
        o = torch.empty_like(q)
        err = flash_attn.call(
            flash_attn.typed(getattr(built[name][0], entry[name]), argtypes),
            q, k, v, o, causal=causal, NB=B * KV, KV=KV, G=H // KV, L=L,
            S=L, strides=flash_attn.model_strides(q, k),
            scratch=flash_attn.tf32_scratch(B * KV, L, hd, dev)
            if tf32 else None, window=0 if windowed else None,
            q_offset=0 if offset else None)
        return err, o

    def fcall(name):
        err, o = flaunch(name)
        if err:
            raise RuntimeError(f"{name}: error {err}")
        return o

    takes = [n for n in entry if flaunch(n)[0] == 0]
    print(json.dumps({"kernel": label, "shape_BLHKVhd": list(shape),
                      "causal": causal,
                      "entry_points": {n: entry[n] for n in takes},
                      "refused_by": [n for n in entry if n not in takes]}),
          flush=True)
    if not takes:
        return
    if compare:
        compare(label, "shape_BLHKVhd", shape, fcall,
                reps if L <= 4096 else long_reps, takes)
        return
    outs = {n: fcall(n) for n in takes}
    first = outs[takes[0]]
    print(json.dumps({
        "kernel": label, "shape_BLHKVhd": list(shape), "causal": causal,
        "bitwise_equal_first": {n: torch.equal(o, first)
                                for n, o in outs.items()},
        "max_abs_gap_first": {n: float((o.float() - first.float())
                                       .abs().max())
                              for n, o in outs.items()}}), flush=True)


def card_line() -> int:
    """Print the card's name and power limit; 0."""
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
