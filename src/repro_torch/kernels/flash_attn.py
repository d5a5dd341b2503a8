"""Flash attention: causal or bidirectional online-softmax attention,
with the G = H / KV query heads of each KV head folded into the row axis.

    flash_mha:       q [N, Lq, hd]; k, v [N, S, hd] -> [N, Lq, hd]
    flash_attention: q [B, L, H, hd]; k, v [B, S, KV, hd] -> [B, L, H*hd]

Row r of the folded axis sits at position l = q_offset + r % seq_len;
with ``causal`` a key j is kept for it when j <= l, and with a sliding
``window`` of W keys when |l - j| < W (the JAX package's `_causal_mask`;
None is no window).  ``q_offset`` is 0 unless the rows are a block of a
longer sequence: a rank's query rows [q_offset, q_offset + seq_len)
against all S keys under sequence-parallel attention ("q_seq"), the
same rows of the whole call.  Every row must keep a key: a window needs
q_offset + seq_len < S + W.  Scores are
(q . k) * (1 / sqrt(hd)), float32; masked scores are NEG_INF = -1e30
(not -inf) and the final divide floors the denominator at 1e-30, the
JAX package's constants.  Inputs are float32 or bfloat16, upcast to
float32; the output is in q's dtype.

Three implementations of that one function live here, and `route`
picks one from the input tensors alone:

- ``"flash_attn_wgmma"``: bfloat16 on a CUDA card, at every head dim of
  HEAD_DIMS, the hand-written Hopper kernel ``csrc/flash_attn_wgmma.cu``
  (tensor cores: wgmma, TMA-fed K/V ring, warp specialisation; 128 query
  rows and 128 keys a tile; a row of hd 16 or 32 is one 32- or 64-byte
  swizzled block; hd 112, zamba2-7b's, runs the hd-128 instance with
  columns 112 to 127 read as zeros), counted in
  ``flash_mha.wgmma_launches``.  This is the serving path's prefill.
- ``"flash_attn_tf32"``: float32 on a CUDA card, at every head dim of
  HEAD_DIMS (qwen2-0.5b's and qwen2-1.5b's float32 prefills at hd 64
  and 128, the serving example's reduced model at hd 32),
  ``csrc/flash_attn_tf32.cu``: the same design on the tensor cores in
  TF32 with every product split 3xTF32 (x = hi + lo, each rounded to
  nearest, ties away; `tf32_rna`), which keeps float32's accuracy where
  TF32 alone would not.  Its entry point first launches a pre-pass (two
  more kernels per call) that writes K and V^T, split, into a scratch
  tensor the wrapper allocates (`tf32_prepass_plain` is its plain
  version); hd 16 runs its hd-32 instance and hd 112 its hd-128 one,
  with K and V^T zero-padded to that width (`tf32_width`).  Counted in
  ``flash_mha.tf32_launches``, once per call.
- ``"plain"``: CPU tensors, `flash_mha_plain` and
  `flash_attention_plain`, the plain PyTorch versions: the same loop
  nest as the Pallas kernel in interpret mode (``q_block`` x
  ``kv_block`` tiles, key tiles in ascending order, the same recurrence
  and constants), vectorized over N.  The CPU tests hold them to the
  JAX kernel; the card's smoke run holds every kernel to them.

The kernels tile with their own compiled sizes, so on the card
``q_block`` and ``kv_block`` are ignored; all read the model's
[B, L, H, hd] layout through strides (no folded copy).  A kernel that
fails to build or launch raises: nothing falls back to another kernel
or to the plain version.

Under autograd, `flash_attention_autograd` is `flash_attention` with a
gradient: a `torch.autograd.Function` whose forward launches the kernel
`route` picks, unchanged, and whose backward (`attention_vjp`)
recomputes the attention in float32 scores one ``q_block`` of queries
at a time and differentiates that in torch ops, as the JAX package
differentiates its `jax.checkpoint`ed `_sdpa` per query block.  The
JAX package has no backward kernel, so neither has the port: the
backward launches no kernel of ours and calls neither plain version.

All three skip a key tile that is masked for every row of the q tile,
by the exact test on the tile's own positions (the Pallas kernel's
``first_q_pos + QB - 1`` is conservative when a q tile straddles two
fold groups): when causal a tile past the largest position, with a
window a tile that ends before the smallest position's window starts
and, bidirectional, one that starts after the largest position's
window ends.  The skip gives the bits of visiting every tile.  A fully
masked tile visited after a row's first kept key leaves (m, l, acc)
unchanged (corr = 1, p = 0).  One visited before it (with a window,
rows of one q tile start their windows at different keys) leaves the
running max at NEG_INF, which is finite, so each masked key adds 1 to
the denominator and v to acc; at the row's first kept key corr =
exp(NEG_INF - m_new) is exactly 0 and wipes both, just as a skipped
tile leaves them 0.  Every row keeps a key, so the denominator is
never 0.  With W >= max(seq_len, S) the window masks nothing and the
tile range is that of no window: the same bits.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MIN_DENOMINATOR = 1e-30
HEAD_DIMS = (16, 32, 64, 112, 128)
# the tf32 kernel's scratch pads S to a multiple of this (its key tile at
# hd 32 and 64; hd 128's 32-key tile divides it), and the order its
# pre-pass stores each group of 8 keys of V^T in: the column order of the
# tf32 wgmma's register A fragment
TF32_KEY_TILE = 64
TF32_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
# its narrowest instance: the pre-pass pads K's columns and V^T's rows of
# a smaller head dim to this width with zeros
TF32_MIN_HEAD_DIM = 32
# head dims that run a wider instance of the tf32 kernel, zero-padded to
# it by the pre-pass
TF32_WIDTHS = {16: TF32_MIN_HEAD_DIM, 112: 128}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _scale(hd: int) -> float:
    return 1.0 / math.sqrt(hd)


def _check_window(window, L: int, S: int, q_offset: int = 0) -> int:
    """The kernels' window code for `window` (None: 0, no window), after
    checking that it is a positive count, that `q_offset` is a count,
    and that every one of the L positions q_offset .. q_offset + L - 1
    keeps a key of the S."""
    if (isinstance(q_offset, bool) or not isinstance(q_offset, int)
            or q_offset < 0):
        raise ValueError(f"q_offset must be an int >= 0, got {q_offset!r}")
    if window is None:
        return 0
    if isinstance(window, bool) or not isinstance(window, int) or window < 1:
        raise ValueError(f"window must be None or a positive int, got "
                         f"{window!r}")
    if q_offset + L >= S + window:
        raise ValueError(f"window={window}: position {q_offset + L - 1} "
                         f"keeps none of the S={S} keys (want q_offset + L "
                         f"< S + window)")
    return window


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           layout: str) -> None:
    """Shapes, dtypes, contiguity and devices the kernel takes, checked
    on every device so a CPU run refuses what the card would."""
    want = 3 if layout == "folded" else 4
    if q.dim() != want or k.dim() != want or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"want q, k, v of {want} dims with k.shape == "
                         f"v.shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    hd = q.shape[-1]
    if hd not in HEAD_DIMS or k.shape[-1] != hd:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS} on q, k and "
                         f"v, got {q.shape[-1]}, {k.shape[-1]}")
    if q.shape[0] != k.shape[0]:
        raise ValueError(f"q and k disagree on the batch: {q.shape[0]} vs "
                         f"{k.shape[0]}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in _DTYPES or x.dtype != q.dtype:
            raise ValueError(f"q, k and v must share one dtype of "
                             f"{list(_DTYPES)}, got {name} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides "
                             f"{x.stride()} for shape {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda tensors, "
                         f"got {q.device}")


def tf32_width(hd: int) -> int:
    """The width of the tf32 kernel's instance that runs head dim `hd`:
    the scratch's columns of K and rows of V^T."""
    return TF32_WIDTHS.get(hd, hd)


def route(q: torch.Tensor) -> str:
    """The implementation that serves `q` (and its k and v, which
    `_check` holds to q's device, dtype and head dim), from q's device
    type and dtype alone: ``"plain"`` on the CPU, ``"flash_attn_wgmma"``
    for bfloat16 on a CUDA card, ``"flash_attn_tf32"`` for float32 on a
    CUDA card, at every head dim of HEAD_DIMS.  The kernels' names are
    their sources under ``csrc/``."""
    if q.device.type == "cpu":
        return "plain"
    return ("flash_attn_wgmma" if q.dtype == torch.bfloat16
            else "flash_attn_tf32")


# the flash kernels' C entry point: q, k, v, o, dtype code, hd, causal,
# window (0: none), q_offset, NB, KV, G, L, S, the 12 strides, scale,
# stream; the tf32 kernel's takes its scratch before the stream
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
               ctypes.c_void_p])
TF32_ARGTYPES = ARGTYPES[:-1] + [ctypes.c_void_p, ctypes.c_void_p]
# an entry point from before the query offset (an older source
# `kernels/ab.py` times): the same but for the q_offset argument
NO_OFFSET_ARGTYPES = ARGTYPES[:8] + ARGTYPES[9:]
NO_OFFSET_TF32_ARGTYPES = TF32_ARGTYPES[:8] + TF32_ARGTYPES[9:]
# one from before the window: neither the window nor q_offset
NO_WINDOW_ARGTYPES = ARGTYPES[:7] + ARGTYPES[9:]
NO_WINDOW_TF32_ARGTYPES = TF32_ARGTYPES[:7] + TF32_ARGTYPES[9:]


def typed(fn, argtypes=ARGTYPES):
    """`fn`, a flash kernel's C entry point from a loaded library, with
    its prototype set."""
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    """Kernel `name`'s C entry point, built and typed once per process."""
    return typed(getattr(build.load(name), f"{name}_launch"),
                 TF32_ARGTYPES if name == "flash_attn_tf32" else ARGTYPES)


def tf32_scratch(NB: int, S: int, hd: int, device) -> torch.Tensor:
    """The tf32 kernel's scratch: K hi, K lo [NB, S_pad, hdp] and V^T hi,
    V^T lo [NB, hdp, S_pad], S_pad = S rounded up to TF32_KEY_TILE, hdp
    = tf32_width(hd)."""
    s_pad = -(-S // TF32_KEY_TILE) * TF32_KEY_TILE
    return torch.empty(4 * NB * s_pad * tf32_width(hd),
                       dtype=torch.float32, device=device)


def model_strides(q: torch.Tensor, k: torch.Tensor) -> tuple:
    """The element strides (batch, row, head) of q, k, v and o in the
    model's contiguous [B, L, H, hd] and [B, S, KV, hd] layouts."""
    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    rows = (L * H * hd, H * hd, hd)
    keys = (S * KV * hd, KV * hd, hd)
    return rows + keys + keys + rows


def call(fn, q, k, v, o, *, causal: bool, NB: int, KV: int, G: int, L: int,
         S: int, strides, scratch: torch.Tensor | None = None,
         window: int | None = 0, q_offset: int | None = 0) -> int:
    """`fn` (a `typed` entry point) on q, k, v and o on the current
    stream; `strides` are the element strides (batch, row, head) of q,
    k, v and o; `scratch` (`tf32_scratch`) only for the tf32 kernel;
    `window` the window code (0: none) and `q_offset` the first row's
    position, each None for an entry point from before it, which takes
    no such argument.  Returns the entry point's error code."""
    arr = (ctypes.c_longlong * 12)(*strides)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    extra = () if scratch is None else (scratch.data_ptr(),)
    opt = tuple(a for a in (window, q_offset) if a is not None)
    with torch.cuda.device(q.device):
        return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  _DTYPES[q.dtype], q.shape[-1], int(causal), *opt, NB, KV,
                  G, L, S, arr, _scale(q.shape[-1]), *extra, stream)


# each kernel's launch count on `flash_mha`
_COUNTERS = {"flash_attn_wgmma": "wgmma_launches",
             "flash_attn_tf32": "tf32_launches"}


def _launch(q, k, v, o, **shape) -> None:
    """Launch the kernel `route` picks (`call`'s arguments), and count
    it."""
    for x in (q, k, v, o):
        if x.data_ptr() % 16:
            raise ValueError("flash attention's kernel reads 16-byte "
                             "aligned rows; got a tensor at an offset")
    name = route(q)
    # freed on return while the kernel may still run: torch's allocator
    # hands the block out again only to work ordered after it on this
    # stream
    scratch = (tf32_scratch(shape["NB"], shape["S"], q.shape[-1], q.device)
               if name == "flash_attn_tf32" else None)
    err = call(_kernel_fn(name), q, k, v, o, scratch=scratch, **shape)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: error {err} "
                           f"(the codes of csrc/{name}.cu's entry point)")
    attr = _COUNTERS[name]
    setattr(flash_mha, attr, getattr(flash_mha, attr) + 1)
    if shape["window"]:
        flash_mha.window_launches += 1
    if shape["q_offset"]:
        flash_mha.offset_launches += 1


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_block: int = 256, kv_block: int = 256,
              seq_len: int = 0, window: int | None = None,
              q_offset: int = 0) -> torch.Tensor:
    """q: [N, Lq, hd]; k, v: [N, S, hd] (heads folded into N) ->
    [N, Lq, hd] in q's dtype.

    `seq_len` is the true sequence length when the row axis folds
    several query heads (row r sits at position q_offset + r % seq_len,
    and Lq must be a multiple of it); 0 means rows == positions.
    `window`: a sliding window of that many keys, None for none.
    `q_offset`: the first row's position (0 unless the rows are a block
    of a longer sequence).  The kernel `route` picks for CUDA tensors,
    the plain version for CPU tensors."""
    _check(q, k, v, "folded")
    N, Lq, hd = q.shape
    S = k.shape[1]
    L = seq_len or Lq
    if Lq % L:
        raise ValueError(f"Lq={Lq} is not a multiple of seq_len={L}")
    code = _check_window(window, L, S, q_offset)
    if route(q) == "plain":
        return flash_mha_plain(q, k, v, causal=causal, q_block=q_block,
                               kv_block=kv_block, seq_len=seq_len,
                               window=window, q_offset=q_offset)
    o = torch.empty_like(q)
    # folded row r = g * L + l of pair n lies at n*Lq*hd + g*L*hd + l*hd
    rows = (Lq * hd, hd, L * hd)
    keys = (S * hd, hd, 0)
    _launch(q, k, v, o, causal=causal, window=code, q_offset=q_offset, NB=N,
            KV=1, G=Lq // L, L=L, S=S, strides=rows + keys + keys + rows)
    return o


flash_mha.wgmma_launches = 0    # csrc/flash_attn_wgmma.cu (tensor cores)
flash_mha.tf32_launches = 0     # csrc/flash_attn_tf32.cu (tensor cores)
flash_mha.window_launches = 0   # either kernel's launches with a window
flash_mha.offset_launches = 0   # either kernel's launches with q_offset > 0


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero: ``cvt.rna.tf32.f32``, in integer bit operations
    (int64, so no int32 add overflows).  The low 13 bits are zero."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r)
    return r.to(torch.int32).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple:
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi): the 3xTF32 split,
    hi + lo within about 2^-22 of x."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tf32_prepass_plain(k: torch.Tensor, v: torch.Tensor) -> tuple:
    """The tf32 kernel's pre-pass on folded float32 k, v [N, S, hd]:
    (K split [2, N, S_pad, hdp], V^T split [2, N, hdp, S_pad]), hi then
    lo, S_pad = S rounded up to TF32_KEY_TILE with zero keys, hdp =
    tf32_width(hd) with zero columns of K and rows of V^T
    past hd, and V^T's keys stored in TF32_KEY_ORDER within each group
    of 8 (stored position p of a group holds key TF32_KEY_ORDER[p]).
    The kernel's scratch holds the two, flattened, one after the other."""
    N, S, hd = k.shape
    s_pad = -(-S // TF32_KEY_TILE) * TF32_KEY_TILE
    hdp = tf32_width(hd)
    pad = lambda x: torch.nn.functional.pad(x.float(),
                                            (0, hdp - hd, 0, s_pad - S))
    order = torch.tensor(TF32_KEY_ORDER, device=k.device)
    keys = (torch.arange(0, s_pad, 8, device=k.device)[:, None]
            + order).reshape(-1)
    vt = pad(v)[:, keys].transpose(1, 2)
    return (torch.stack(tf32_split(pad(k))),
            torch.stack(tf32_split(vt.contiguous())))


def _tile_skipped(k0: int, k1: int, min_pos: int, max_pos: int,
                  causal: bool, window: int | None) -> bool:
    """Whether the key tile [k0, k1) is masked for every position
    min_pos .. max_pos of a q tile (q_offset included): the kernels'
    `key_tiles` test."""
    if causal and k0 > max_pos:
        return True
    if window is None:
        return False
    return k1 - 1 <= min_pos - window or (not causal
                                          and k0 >= max_pos + window)


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_block: int = 256,
                    kv_block: int = 256, seq_len: int = 0,
                    window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """The kernel's function in torch ops on any device: the Pallas
    kernel's loop nest (q tiles of ``q_block`` rows, key tiles of
    ``kv_block`` keys in ascending order, the online-softmax recurrence
    in float32), vectorized over N, skipping the key tiles that are
    masked for every row of a q tile at both ends (`_tile_skipped`).
    Ragged Lq and S end in short tiles.  Row r sits at position
    q_offset + r % seq_len."""
    N, Lq, hd = q.shape
    S = k.shape[1]
    L = seq_len or Lq
    _check_window(window, L, S, q_offset)
    QB, KB = min(q_block, Lq), min(kv_block, S)
    scale = _scale(hd)
    dev = q.device
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty_like(q)
    for q0 in range(0, Lq, QB):
        q1 = min(q0 + QB, Lq)
        qt = qf[:, q0:q1]
        q_pos = q_offset + torch.arange(q0, q1, device=dev) % L
        one_group = q0 // L == (q1 - 1) // L
        min_pos = q_offset + (q0 % L if one_group else 0)
        max_pos = q_offset + ((q1 - 1) % L if one_group else L - 1)
        acc = torch.zeros((N, q1 - q0, hd), dtype=torch.float32, device=dev)
        m = torch.full((N, q1 - q0, 1), NEG_INF, dtype=torch.float32,
                       device=dev)
        den = torch.zeros((N, q1 - q0, 1), dtype=torch.float32, device=dev)
        for k0 in range(0, S, KB):
            k1 = min(k0 + KB, S)
            if _tile_skipped(k0, k1, min_pos, max_pos, causal, window):
                continue
            s = (qt @ kf[:, k0:k1].transpose(1, 2)) * scale
            if causal or window is not None:
                k_pos = torch.arange(k0, k1, device=dev)
                s = s.masked_fill(_masked(q_pos, k_pos, causal, window),
                                  NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            e = torch.exp(s - m_new)
            den = den * corr + e.sum(-1, keepdim=True)
            m = m_new
            acc = acc * corr + e @ vf[:, k0:k1]
        out[:, q0:q1] = (acc / den.clamp_min(MIN_DENOMINATOR)).to(q.dtype)
    return out


def _masked(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
            window: int | None) -> torch.Tensor:
    """[len(q_pos), len(k_pos)] bool, True where the key is masked for
    the query: past it when causal, |q - k| >= window with a window."""
    d = q_pos[:, None] - k_pos[None, :]
    out = (d < 0) if causal else torch.zeros_like(d, dtype=torch.bool)
    if window is not None:
        out = out | (d.abs() >= window)
    return out


def _fold(q, k, v):
    """[B, L, H, hd], [B, S, KV, hd] -> [B*KV, G*L, hd], [B*KV, S, hd]
    (the JAX wrapper's transposed copies)."""
    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = (q.reshape(B, L, KV, G, hd).permute(0, 2, 3, 1, 4)
          .reshape(B * KV, G * L, hd))
    kf = k.permute(0, 2, 1, 3).reshape(B * KV, S, hd)
    vf = v.permute(0, 2, 1, 3).reshape(B * KV, S, hd)
    return qf, kf, vf


def _check_gqa(q, k) -> None:
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"H={q.shape[2]} query heads do not fold over "
                         f"KV={k.shape[2]} heads")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_block: int = 256,
                    kv_block: int = 256, window: int | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """GQA wrapper. q: [B, L, H, hd]; k, v: [B, S, KV, hd] ->
    [B, L, H*hd] in q's dtype.  Query head h = kv * G + g attends to KV
    head kv, G = H / KV; `window` a sliding window of that many keys
    (None: none); query row l sits at position q_offset + l.  The kernel
    `route` picks (reading this layout in place) for CUDA tensors, the
    plain version for CPU tensors."""
    _check(q, k, v, "model")
    _check_gqa(q, k)
    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    code = _check_window(window, L, S, q_offset)
    if route(q) == "plain":
        return flash_attention_plain(q, k, v, causal=causal, q_block=q_block,
                                     kv_block=kv_block, window=window,
                                     q_offset=q_offset)
    o = torch.empty_like(q)
    _launch(q, k, v, o, causal=causal, window=code, q_offset=q_offset,
            NB=B * KV, KV=KV, G=H // KV, L=L, S=S,
            strides=model_strides(q, k))
    return o.reshape(B, L, H * hd)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_block: int = 256,
                          kv_block: int = 256, window: int | None = None,
                          q_offset: int = 0) -> torch.Tensor:
    """`flash_attention` through the fold, `flash_mha_plain` and the
    unfold, as the JAX wrapper composes them."""
    _check_gqa(q, k)
    B, L, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    of = flash_mha_plain(*_fold(q, k, v), causal=causal, q_block=q_block,
                         kv_block=kv_block, seq_len=L, window=window,
                         q_offset=q_offset)
    return (of.reshape(B, KV, G, L, hd).permute(0, 3, 1, 2, 4)
            .reshape(B, L, H * hd))


def attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, *, causal: bool = True,
                  q_block: int = 512, window: int | None = None,
                  q_offset: int = 0) -> tuple:
    """(dq, dk, dv) of `flash_attention`'s output at q [B, L, H, hd], k,
    v [B, S, KV, hd] (query row l at position q_offset + l) against the
    output's cotangent do [B, L, H*hd], each in its input's dtype.

    The attention is recomputed in float32, ``q_block`` queries at a
    time (their G = H / KV heads of each KV head together): scores
    (q . k) / sqrt(hd), masked to NEG_INF where a key lies past the
    query's position (causal) or |q - k| >= window (a sliding window),
    softmax p, and then the softmax attention's gradient, dv += p^T do,
    ds = p * (do v^T - rowsum(do v^T * p)), dq = ds k / sqrt(hd), dk +=
    ds^T q / sqrt(hd).  A block of queries at positions [p0, p1) reads
    only the keys that some of its rows keep: up to its last position
    when causal, and with a window from p0 - window + 1 and,
    bidirectional, up to p1 + window - 2 (the others are masked for all
    its rows, p exactly 0 there), so a windowed backward's work scales
    with the window, not with L."""
    B, L, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = _scale(hd)
    dev = q.device
    kf = k.float().permute(0, 2, 1, 3)                       # [B, KV, S, hd]
    vf = v.float().permute(0, 2, 1, 3)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dq = torch.empty((B, L, H, hd), dtype=torch.float32, device=dev)
    q5 = q.reshape(B, L, KV, G, hd)
    do5 = do.reshape(B, L, KV, G, hd)

    def rows(x, n):       # [B, n, KV, G, hd] -> [B, KV, G * n, hd]
        return x.float().permute(0, 2, 3, 1, 4).reshape(B, KV, G * n, hd)

    _check_window(window, L, S, q_offset)
    for q0 in range(0, L, q_block):
        q1 = min(q0 + q_block, L)
        n = q1 - q0
        p0, p1 = q_offset + q0, q_offset + q1
        start = 0 if window is None else max(0, p0 - window + 1)
        end = (min(p1, S) if causal else S if window is None
               else min(S, p1 + window - 1))
        qb, dob = rows(q5[:, q0:q1], n), rows(do5[:, q0:q1], n)
        kt, vt = kf[:, :, start:end], vf[:, :, start:end]
        s = (qb @ kt.transpose(-1, -2)) * scale    # [B, KV, G*n, end-start]
        if causal or window is not None:
            q_pos = torch.arange(p0, p1, device=dev).repeat(G)
            k_pos = torch.arange(start, end, device=dev)
            s = s.masked_fill(_masked(q_pos, k_pos, causal, window),
                              NEG_INF)
        p = torch.softmax(s, dim=-1)
        dv[:, :, start:end] += p.transpose(-1, -2) @ dob
        dp = dob @ vt.transpose(-1, -2)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        dk[:, :, start:end] += (ds.transpose(-1, -2) @ qb) * scale
        dq[:, q0:q1] = ((ds @ kt) * scale).reshape(B, KV, G, n, hd).permute(
            0, 3, 1, 2, 4).reshape(B, n, H, hd)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """`flash_attention` forward (the routed kernel, unchanged) with
    `attention_vjp` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_block, kv_block, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_block, ctx.window = causal, q_block, window
        ctx.q_offset = q_offset
        return flash_attention(q, k, v, causal=causal, q_block=q_block,
                               kv_block=kv_block, window=window,
                               q_offset=q_offset)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_vjp(q, k, v, do, causal=ctx.causal,
                                   q_block=ctx.q_block, window=ctx.window,
                                   q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_autograd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             q_block: int = 256, kv_block: int = 256,
                             window: int | None = None,
                             q_offset: int = 0) -> torch.Tensor:
    """`flash_attention` (same arguments, same launches, same output
    bits) that autograd differentiates through `attention_vjp`, its
    float32 recompute one ``q_block`` of queries at a time."""
    return _FlashAttention.apply(q, k, v, causal, q_block, kv_block, window,
                                 q_offset)
