"""Wrappers of the Hopper kernels, with their launch counters.

Each WF wrapper takes the natural row layout — reads ``s1`` (R, n) and
windows ``s2_window`` (R, n + 2*eth), both uint8 and contiguous —,
``minimizer_scan`` sequences (R, L) uint8, and ``flash_attention`` the
LM layers' (B, S, H, hd) layout.  Each checks its input, and then:

  * on CUDA tensors launches its kernel on the tensor's device and that
    device's current stream (building the library at first use), and
    adds one to its entry of ``LAUNCHES``; a refused launch raises
    ``KernelLaunchError``;
  * on CPU tensors runs the kernel's plain torch version (from
    ``repro_torch.core``) — the only case where the plain version stands
    in, and it does so because of where the tensor lies.

The counters count launches and nothing else, so a run can show that
its main path went through the kernels.
"""
from __future__ import annotations

import math

import torch

from ..core.affine_wf import banded_affine, banded_affine_dist, traceback
from ..core.attention import _sdpa_chunked
from ..core.linear_wf import banded_wf
from ..core.minimizers import minimizers
from . import build

LAUNCHES = {"linear_wf": 0, "affine_wf_dist": 0, "affine_wf": 0,
            "affine_traceback": 0, "minimizer_scan": 0,
            "flash_attention": 0, "flash_attention_wgmma": 0}
SUPPORTED_ETH = tuple(range(13))  # instances 0..wf::MAX_ETH (wf_common.cuh)
MAX_SAT = 85                # above it the reference's int8 values wrap
SMEM_LIMIT = 232_448        # dynamic shared memory a Hopper block may use
CAP_ROWS = 128              # rows of the read-length rule (_check_read_len)
DIR_ROWS = 256              # instances a block of the padded affine kernel
SMEM_DEFAULT = 48 * 1024    # shared memory a block gets without opting in
MINI_THREADS = 128          # minimizer block size
TB_THREADS = (128, 64, 32)  # fused traceback block sizes, largest first
MINI_WINDOWS = 1024         # windows a minimizer block aims to cover
FLASH_HEAD_DIMS = (16, 32, 64, 80, 128)  # head_dim instances of each kernel
FLASH_DTYPES = (torch.float32, torch.bfloat16)
TMA_ALIGN = 16              # bytes: a TMA load's base and strides


# the C entry points of the mapper's kernels (the WF stages, seeding and
# the index build's scan): ``load_mapper_kernels`` builds and loads them
MAPPER_ENTRIES = ("linear_wf_launch", "affine_wf_dist_launch",
                  "affine_wf_launch", "affine_traceback_launch",
                  "minimizer_launch")


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error.  The context may be unusable
    afterwards, so the resilience layer re-raises it instead of retrying
    the block or degrading to the plain versions on the same device."""


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load_mapper_kernels() -> None:
    """Build (where not built yet) and load every mapper kernel library
    now, so that a compile failure raises here and not inside a caller's
    first launch; raises ``build.KernelBuildError``."""
    for fn in MAPPER_ENTRIES:
        build.entry(fn)


def _check(s1: torch.Tensor, s2_window: torch.Tensor, eth: int) -> None:
    for name, t in (("s1", s1), ("s2_window", s2_window)):
        if t.dtype != torch.uint8:
            raise TypeError(f"{name} must be uint8, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor, got "
                             f"shape {tuple(t.shape)}")
    R, n = s1.shape
    if tuple(s2_window.shape) != (R, n + 2 * eth):
        raise ValueError(f"s2_window shape {tuple(s2_window.shape)} does "
                         f"not match s1 {(R, n)} with eth={eth}")
    if s1.device != s2_window.device:
        raise ValueError(f"s1 on {s1.device}, s2_window on "
                         f"{s2_window.device}")


def _is_cuda(t: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for a CUDA tensor;
    raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def _check_eth_sat(eth: int, sat: int | None) -> None:
    if eth not in SUPPORTED_ETH:
        raise ValueError(f"eth={eth} has no compiled kernel instance; "
                         f"supported: {SUPPORTED_ETH[0]}..{SUPPORTED_ETH[-1]}")
    if sat is not None and not 0 <= sat <= MAX_SAT:
        raise ValueError(f"sat={sat} outside [0, {MAX_SAT}]: the "
                         f"reference's int8 band values would wrap")


def _check_read_len(n: int, eth: int) -> None:
    """Raises ValueError, naming ``read_len``, for a read longer than the WF
    kernels take at ``eth``: CAP_ROWS reads and windows (2n + 2*eth bytes
    each) must fit a block's shared memory, which caps n at 908 - eth.
    The rule is the first padded affine kernel's, which staged its rows
    whole; no kernel stages whole rows now (the padded kernel and the two
    distance kernels stage 32 columns at a time), but the rule stays so
    that the card takes the geometries it took, and the distance kernels
    need a cap: they hold band values in 16-bit lanes, exact only while n
    stays well below 32,767 - 255 - MAX_SAT."""
    need = CAP_ROWS * (2 * n + 2 * eth)
    if need > SMEM_LIMIT:
        longest = (SMEM_LIMIT // CAP_ROWS - 2 * eth) // 2
        raise ValueError(f"read_len={n}, eth={eth}: longer than the WF "
                         f"kernels take ({longest} bases at eth={eth})")


def check_wf_geometry(eth: int, read_len: int, sat: int, *,
                      traceback: bool = True) -> None:
    """Raises ValueError, naming the field, unless the WF kernels take
    reads of ``read_len`` at band half-width ``eth`` and affine saturation
    ``sat`` on the card: ``eth`` in ``SUPPORTED_ETH``, ``sat`` in [0,
    ``MAX_SAT``], ``read_len`` within ``_check_read_len``'s cap and, with
    ``traceback``, the fused traceback's directions (a 32-bit word per 8
    band cells of a row) for a block of at least 32 instances too
    (``traceback_threads``).  Sessions call it before any work, so that a
    configuration the kernels refuse fails before the index build rather
    than at the first launch; the plain versions take any of them."""
    _check_eth_sat(eth, sat)
    _check_read_len(read_len, eth)
    if traceback:
        traceback_threads(read_len, eth)


def _on_card(s1: torch.Tensor, eth: int, sat: int | None = None) -> bool:
    """False for CPU tensors (plain version); True for CUDA tensors the
    kernels take; raises for anything else."""
    if not _is_cuda(s1):
        return False
    _check_eth_sat(eth, sat)
    return True


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise KernelLaunchError(f"{what} kernel launch failed: "
                                f"cudaError_t {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def linear_wf(s1: torch.Tensor, s2_window: torch.Tensor, *, eth: int = 6):
    """Banded linear WF.  -> (dist_end (R,), dist_min (R,)) int32."""
    _check(s1, s2_window, eth)
    if not _on_card(s1, eth):
        return banded_wf(s1, s2_window, eth=eth)
    R, n = s1.shape
    _check_read_len(n, eth)
    out = torch.empty((2, R), dtype=torch.int32, device=s1.device)
    if R:
        with torch.cuda.device(s1.device):
            rc = build.entry("linear_wf_launch")(
                s1.data_ptr(), s2_window.data_ptr(), out.data_ptr(), R, n,
                eth, _stream(s1))
        _raise_on(rc, "linear_wf")
        LAUNCHES["linear_wf"] += 1
    return out[0], out[1]


def affine_wf_dist(s1: torch.Tensor, s2_window: torch.Tensor, *,
                   eth: int = 6, sat: int = 32):
    """Distance-only banded affine WF.  -> (dist_end, dist_min) int32.
    The kernel runs two instances a thread in blocks of its own size."""
    _check(s1, s2_window, eth)
    if not _on_card(s1, eth, sat):
        return banded_affine_dist(s1, s2_window, eth=eth, sat=sat)
    R, n = s1.shape
    _check_read_len(n, eth)
    out = torch.empty((2, R), dtype=torch.int32, device=s1.device)
    if R:
        with torch.cuda.device(s1.device):
            rc = build.entry("affine_wf_dist_launch")(
                s1.data_ptr(), s2_window.data_ptr(), out.data_ptr(), R, n,
                eth, sat, _stream(s1))
        _raise_on(rc, "affine_wf_dist")
        LAUNCHES["affine_wf_dist"] += 1
    return out[0], out[1]


def dir_planes(R: int, n: int, eth: int, device) -> tuple:
    """The buffer ``affine_wf``'s kernel writes its direction planes into,
    and the (R, n, band) view of it that the wrapper returns.  The buffer
    keeps the Pallas kernel's (n * band, R) layout, byte (cell, r) at cell
    * Rp + r, with R padded to Rp, a multiple of DIR_ROWS (the instances
    of a kernel block, ``2 * DIR_THREADS`` in csrc/affine_wf.cu): every
    thread of a launch stores its two instances' bytes of a cell in one
    aligned 16-bit store, those past R into the padding, with no branch.
    The view leaves the padding out and is not a copy: strides (1, band *
    Rp, Rp)."""
    band = 2 * eth + 1
    planes = torch.empty((n * band, -(-R // DIR_ROWS) * DIR_ROWS),
                         dtype=torch.uint8, device=device)
    return planes, planes[:, :R].t().reshape(R, n, band)


def affine_wf(s1: torch.Tensor, s2_window: torch.Tensor, *, eth: int = 6,
              sat: int = 32):
    """Banded affine WF with its packed direction planes.  -> (dist_end
    (R,), dist_min (R,)) int32 and dirs (R, n, 2*eth+1) uint8.

    The kernel runs two instances a thread and writes the planes in the
    Pallas kernel's (n * band, R) layout, R padded (``dir_planes``), where
    a warp's stores coalesce; ``dirs`` is an (R, n, band) view of that
    buffer, not a transposed copy.
    """
    _check(s1, s2_window, eth)
    if not _on_card(s1, eth, sat):
        return banded_affine(s1, s2_window, eth=eth, sat=sat)
    R, n = s1.shape
    _check_read_len(n, eth)
    dev = s1.device
    dists = torch.empty((2, R), dtype=torch.int32, device=dev)
    # every byte of the view is written by the kernel (0 left of column
    # 0): no fill
    planes, dirs = dir_planes(R, n, eth, dev)
    if R:
        with torch.cuda.device(dev):
            rc = build.entry("affine_wf_launch")(
                s1.data_ptr(), s2_window.data_ptr(), dists.data_ptr(),
                planes.data_ptr(), R, planes.shape[1], n, eth, sat,
                _stream(s1))
        _raise_on(rc, "affine_wf")
        LAUNCHES["affine_wf"] += 1
    return dists[0], dists[1], dirs


def minimizer_layout(L: int, k: int, w: int):
    """(rows a block, threads a block, shared memory bytes) of the
    minimizer kernel for rows of L bases: a block stages whole rows, L
    bases, a 32-bit hash a k-mer and two (hash, position) pairs a window
    (its suffix and prefix minima) each, the bases in 16-byte chunks (32
    bytes of slack); as many rows as make MINI_WINDOWS windows.  Raises
    ValueError, naming ``read_len``, for a row that does not fit a
    block's default shared memory."""
    n_kmers = L - k + 1
    n_win = n_kmers - w + 1

    def smem(rpb):                    # csrc/minimizer.cu stage_offset
        return (-(-rpb * (16 * n_win + 4 * n_kmers) // 16) * 16 + rpb * L
                + 32)
    if smem(1) > SMEM_DEFAULT:
        raise ValueError(f"read_len={L}: one row's {smem(1)} B of minima, "
                         f"hashes and bases exceed a block's {SMEM_DEFAULT} "
                         f"B")
    rpb = -(-MINI_WINDOWS // n_win)
    while smem(rpb) > SMEM_DEFAULT:
        rpb -= 1
    return rpb, MINI_THREADS, smem(rpb)


def minimizer_scan(seqs: torch.Tensor, *, k: int = 12, w: int = 30,
                   codes: bool = False):
    """Window minimizers of every row of ``seqs`` (R, L) uint8 base codes.
    -> (first (R, n_win), positions (R, n_win)), both int64, n_win =
    L - (w + k - 1) + 1: for each window of w consecutive k-mers, its
    smallest hash32 (uint32 values held in int64; with ``codes``, the
    k-mer code of that minimizer instead) and the k-mer start of its
    leftmost occurrence, as ``core.minimizers.minimizers`` gives them
    (``[0]`` and ``[2]``, or with ``codes`` ``[1:]``).  The kernel is
    compiled for both choices of the first output."""
    if seqs.dtype != torch.uint8:
        raise TypeError(f"seqs must be uint8, got {seqs.dtype}")
    if seqs.dim() != 2 or not seqs.is_contiguous():
        raise ValueError(f"seqs must be a contiguous 2-D tensor, got shape "
                         f"{tuple(seqs.shape)}")
    if not 1 <= k <= 16:
        raise ValueError(f"k={k}: k-mer codes must fit 32 bits (1..16)")
    if w < 1:
        raise ValueError(f"w={w} must be >= 1")
    R, L = seqs.shape
    if L < w + k - 1:
        raise ValueError(f"L={L} is shorter than one window of w={w} "
                         f"k-mers of k={k} ({w + k - 1} bases)")
    if not _is_cuda(seqs):
        hashes, kmers, pos = minimizers(seqs, k=k, w=w)
        return (kmers if codes else hashes), pos
    rpb, threads, smem = minimizer_layout(L, k, w)
    n_win = L - (w + k - 1) + 1
    dev = seqs.device
    first = torch.empty((R, n_win), dtype=torch.int64, device=dev)
    pos = torch.empty((R, n_win), dtype=torch.int64, device=dev)
    if R:
        with torch.cuda.device(dev):
            rc = build.entry("minimizer_launch")(
                seqs.data_ptr(), first.data_ptr(), pos.data_ptr(), R, L, k,
                w, int(codes), rpb, threads, smem, _stream(seqs))
        _raise_on(rc, "minimizer_scan")
        LAUNCHES["minimizer_scan"] += 1
    return first, pos


def traceback_smem(n: int, eth: int, threads: int) -> int:
    """Shared memory of a fused traceback block of ``threads`` instances:
    each instance's directions, one 32-bit word per 8 band cells of each
    of its n rows."""
    return threads * n * 4 * ((2 * eth + 8) // 8)


def traceback_threads(n: int, eth: int) -> int:
    """Threads per block of the fused traceback kernel: the most of
    ``TB_THREADS`` whose shared memory (``traceback_smem``) fits a
    block's."""
    for threads in TB_THREADS:
        if traceback_smem(n, eth, threads) <= SMEM_LIMIT:
            return threads
    raise ValueError(f"read_len={n}, eth={eth}: "
                     f"{traceback_smem(n, eth, TB_THREADS[-1])} B of "
                     f"directions for {TB_THREADS[-1]} instances do not fit "
                     f"in {SMEM_LIMIT} B of shared memory")


def affine_traceback(s1: torch.Tensor, s2_window: torch.Tensor, *,
                     eth: int = 6, sat: int = 32, max_ops: int):
    """Fused banded affine WF + traceback.  -> (dist_end (R,), dist_min
    (R,), ops (R, max_ops) int32 END-aligned, op_count (R,) int32).

    The kernel runs one instance a thread in blocks of
    ``traceback_threads(n, eth)``; a block keeps its instances' direction
    nibbles in shared memory, 8 to a 32-bit word laid out [row][word]
    [instance] (``traceback_smem``), and fills its op rows with OP_NONE
    before the walks write their ops."""
    _check(s1, s2_window, eth)
    if max_ops < 1:
        raise ValueError(f"max_ops={max_ops} must be >= 1")
    if not _on_card(s1, eth, sat):
        de, dm, dirs = banded_affine(s1, s2_window, eth=eth, sat=sat)
        ops_, cnt = traceback(dirs, eth, max_ops)
        return de, dm, ops_, cnt
    R, n = s1.shape
    threads = traceback_threads(n, eth)
    dev = s1.device
    dists = torch.empty((2, R), dtype=torch.int32, device=dev)
    ops_ = torch.empty((R, max_ops), dtype=torch.int32, device=dev)
    cnt = torch.empty((R,), dtype=torch.int32, device=dev)
    if R:
        smem = traceback_smem(n, eth, threads)
        with torch.cuda.device(dev):
            rc = build.entry("affine_traceback_launch")(
                s1.data_ptr(), s2_window.data_ptr(), dists.data_ptr(),
                ops_.data_ptr(), cnt.data_ptr(), R, n, eth, sat, max_ops,
                threads, smem, _stream(s1))
        _raise_on(rc, "affine_traceback")
        LAUNCHES["affine_traceback"] += 1
    return dists[0], dists[1], ops_, cnt


def flash_kernel(dtype: torch.dtype, hd: int) -> str:
    """The kernel ``flash_attention`` launches for CUDA inputs of ``dtype``
    at head dim ``hd``, one of ``FLASH_HEAD_DIMS``:
    ``"flash_attention_wgmma"`` (tensor cores fed by TMA) for bfloat16,
    ``"flash_attention"`` (the CUDA cores) for float32.  Raises for what
    neither takes."""
    if dtype not in FLASH_DTYPES:
        raise TypeError(f"no flash kernel for {dtype}")
    if hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim={hd} has no compiled kernel instance; "
                         f"supported: {FLASH_HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "flash_attention_wgmma"
    return "flash_attention"


def check_tma(name: str, ptr: int, strides, itemsize: int) -> None:
    """Raises ValueError unless a tensor at address ``ptr`` with element
    ``strides`` (batch, seq, head; head_dim contiguous) and elements of
    ``itemsize`` bytes meets the TMA's rules: the base and every stride a
    multiple of ``TMA_ALIGN`` bytes."""
    if ptr % TMA_ALIGN:
        raise ValueError(f"{name}'s data pointer {ptr:#x} is not "
                         f"{TMA_ALIGN}-byte aligned, as a TMA load needs")
    for s in strides:
        if s * itemsize % TMA_ALIGN:
            raise ValueError(f"{name}'s strides {tuple(strides)} (elements "
                             f"of {itemsize} bytes) are not all multiples "
                             f"of {TMA_ALIGN} bytes, as a TMA load needs")


def check_no_grad(name: str, requires_grad: bool,
                  grad_enabled: bool) -> None:
    """Raises ``KernelLaunchError`` for a flash input that autograd would
    record (it ``requires_grad`` and gradients are enabled): the kernels
    have no backward, and a launch would cut the gradient off silently.
    ``models.layers.attention`` sends such inputs to ``_sdpa_chunked``'s
    gradient route; this rule holds for CUDA tensors, the plain version
    on CPU tensors being differentiable."""
    if requires_grad and grad_enabled:
        raise KernelLaunchError(
            f"flash_attention: {name} requires grad and the kernels have no "
            f"backward; differentiate core.attention._sdpa_chunked instead "
            f"(models.layers.attention's gradient route)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 512):
    """Causal or bidirectional attention with GQA, in the layers layout:
    q (B, S, H, hd); k, v (B, S, KV, hd) -> (B, S, H, hd) in q's dtype.
    Query head h reads KV head h // (H // KV).

    ``q_chunk``/``kv_chunk`` are the reference's blocking: they are
    checked as it asserts them (S divisible by min(chunk, S)) and set the
    plain version's chunks; the kernels pick their own tiles.  The kernels
    compute ``_sdpa_chunked(..., f32_scores=True)``; on CPU tensors the
    wrapper runs ``_sdpa_chunked`` with the reference model's products in
    the inputs' dtype, the same function for float32 inputs.  Takes
    float32 and bfloat16 at head dims ``FLASH_HEAD_DIMS``; ``flash_kernel``
    picks the kernel: bfloat16 goes to the tensor-core kernel, float32 to
    the CUDA-core kernel.  Strided inputs are read in place as long as
    head_dim is contiguous; the tensor-core kernel loads them by TMA and
    raises (no other kernel stands in) unless each base and stride is a
    multiple of 16 bytes (``check_tma``), which the layers' (B, S, heads,
    hd) tensors, each a contiguous projection of its own, always meet.
    ``LAUNCHES["flash_attention"]`` counts every launch,
    ``LAUNCHES["flash_attention_wgmma"]`` those of the tensor-core
    kernel.  A CUDA input that requires grad is refused
    (``check_no_grad``): the kernels have no backward."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D (B, S, heads, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in FLASH_DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape != v.shape or (k.shape[0], k.shape[1], k.shape[3]) != (
            B, S, hd):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"both be (B, S, KV, hd) = ({B}, {S}, KV, {hd})")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV "
                         f"heads")
    for name, c in (("q_chunk", q_chunk), ("kv_chunk", kv_chunk)):
        if c < 1 or S % min(c, S):
            raise ValueError(f"S={S} is not divisible by {name}={c}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    if not _is_cuda(q):
        return _sdpa_chunked(q, k, v, causal, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_no_grad(name, t.requires_grad, torch.is_grad_enabled())
    kernel = flash_kernel(q.dtype, hd)
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("head_dim must be the contiguous axis of q, k, v")
    if k.stride() != v.stride():
        raise ValueError(f"k and v strides differ: {k.stride()}, "
                         f"{v.stride()}")
    if kernel == "flash_attention_wgmma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_tma(name, t.data_ptr(), t.stride()[:3], t.element_size())
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if out.numel():
        with torch.cuda.device(q.device):
            rc = build.entry(f"{kernel}_launch")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, H, KV, hd, int(causal), 1.0 / math.sqrt(hd),
                *q.stride()[:3], *k.stride()[:3], *out.stride()[:3],
                _stream(q))
        _raise_on(rc, kernel)
        LAUNCHES["flash_attention"] += 1
        if kernel == "flash_attention_wgmma":
            LAUNCHES[kernel] += 1
    return out
