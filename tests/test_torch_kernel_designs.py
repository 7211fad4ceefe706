"""The arithmetic of K5's and K1's card designs, emulated on the CPU in
plain PyTorch and held to the plain versions, which define the functions.

K5 (csrc/stats.cu) takes the 24 bisection rounds of
ops/stats.py:_order_stat_pair four at a time: the 15 midpoints of four
rounds form a tree built with the rounds' own f32 operations; one sweep
buckets the values inside the bracket by the number of midpoints below
them (a 4-step search), and the counts at each node (plus the count
below the bracket) decide the four rounds.  Where the tree is not
ordered inside its bracket (lo + hi overflows f32) the sweep counts each
midpoint directly.  The pin takes the smallest bracket member, its
multiplicity and the next distinct member in one sweep.
`four_round_search` below does the same; its brackets must equal the
binary search's bit for bit, and its pinned values the plain version's.
`kernel_clip_stats` runs the whole clip loop so, a later stats_of's
first pass counting only the values the kept set lost, and takes the
moments as the kernel does: f64 sums in the kernel's order (each thread's
values, then the warp's butterfly, the warps, the blocks), the mean and
variance in f64, each rounded once to f32.

K1 (csrc/nms.cu) builds the kill mask by (row, word) threads, the
image's columns in shared memory at position l * words + u for column
32 * u + l and each block's rows interleaved with the other blocks',
then scans it 32 rows a step: the block's removed word and its rows'
diagonal words resolve the 32 greedy decisions, and the kept rows'
later words are ORed into the removed words.  `word_scan` below does the
same on integer bitmasks; its keep masks must equal `suppress_plain`'s.

K6 (csrc/histeq.cu, cluster route) splits each plane into the cluster's
blocks, combines their min/max/NaN partials, adds their histograms and
scans the 256 bins eight warps of 32 at a time; `cluster_histeq` below
does the same, and its output must equal `equalize_hist`'s bit for bit.

K8 (csrc/shift.cu) indexes a row by j + k*C on the row route, and on
the column route stages, for each strip of X columns and band of Y
output rows, only the source rows the band's taps reach (or reads
device memory when they do not fit); `row_route` and `column_route`
below do the same, and their outputs must equal `row_shift_plain`'s bit
for bit.

K3 (csrc/preproc.cu, cluster route) splits each plane into the
cluster's blocks, each part into segments as its bulk copies land,
stretches every pixel once, combines the parts' masked min/max and
normalises each part on its own; `cluster_zscale_minmax` below does the
same, and its output and limits must equal `zscale_minmax_plain`'s bit
for bit.

K7 (csrc/clahe.cu, cluster route) gives each block of the cluster whole
rows of the plane, bins each pixel once and counts it at every padded
position it takes (the reflect pad counts its source pixel again) into
the tile rows the block touches, adds those counts into every block whose
taps reach their tile rows, builds the CDFs of its taps' tile rows from
the counts it received and blends from them with taps made once a row
and once a column; `cluster_clahe` below does the same, and its output
must equal `equalize_adapthist_plain`'s bit for bit.

K4's backward (csrc/upsample.cu) reads the incoming gradient where it
lies, through its batch, row and pixel strides, one vector of L
channels of one output pixel a thread: `strided_upsample_backward`
below indexes the gradient's storage the same way, and must equal
`upsample2x_backward_plain` bit for bit on the concat's channel slices.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from caesar_yolo_tpu_torch.detect import cuda_nms
from caesar_yolo_tpu_torch.ops import (clahe, cuda_clahe, cuda_histeq,
                                       cuda_preproc,
                                       cuda_shift, cuda_stats, cuda_upsample,
                                       stats)
from caesar_yolo_tpu_torch.ops.zscale import zscale_apply, zscale_limits
from caesar_yolo_tpu_torch.ops.histeq import NBINS, _to_index, equalize_hist
from caesar_yolo_tpu_torch.utils.boxes import iou_matrix

torch.set_num_threads(1)

LEVELS = 4                # bisection rounds a pass
BINS = 1 << LEVELS        # 15 midpoints, 16 buckets


def _mid(a, b):
    return 0.5 * (a + b)  # f32 tensors: one rounded add, an exact halving


def tree(lo, hi):
    """[P] brackets -> [P, 15] midpoints of four rounds, in order."""
    m = [None] * (BINS - 1)
    m[7] = _mid(lo, hi)
    m[3], m[11] = _mid(lo, m[7]), _mid(m[7], hi)
    m[1], m[5] = _mid(lo, m[3]), _mid(m[3], m[7])
    m[9], m[13] = _mid(m[7], m[11]), _mid(m[11], hi)
    ends = [lo, m[1], m[3], m[5], m[7], m[9], m[11], m[13], hi]
    for j in range(8):
        m[2 * j] = _mid(ends[j], ends[j + 1])
    return torch.stack(m, dim=1)


def bucket(mids, x):
    """The kernel's 4-step search for the number of (ordered) midpoints
    below each value of x [P, N] (m[15] = +inf)."""
    pad = torch.cat([mids, torch.full_like(mids[:, :1], float("inf"))], 1)
    r = torch.zeros(x.shape, dtype=torch.int64)
    for step in (8, 4, 2, 1):
        probe = torch.gather(pad, 1, r + step - 1)
        r = r + torch.where(probe < x, step, 0)
    return r


def node_counts(xm, lo, hi, clo, mids):
    """count(xm <= mids[:, j]) for each node, as the kernel gets it."""
    ordered = ((lo <= mids[:, 0]) & (mids[:, -1] <= hi)
               & (mids[:, :-1] <= mids[:, 1:]).all(dim=1))
    inb = (xm > lo[:, None]) & (xm <= hi[:, None])
    r = torch.where(inb, bucket(mids, xm), BINS)   # BINS: not counted
    below = (mids[:, None, :] < xm[:, :, None]).sum(2)
    assert torch.equal(torch.where(inb & ordered[:, None], r, 0),
                       torch.where(inb & ordered[:, None], below, 0))
    hist = torch.stack([(r == j).sum(1) for j in range(BINS - 1)], 1)
    cum = clo[:, None] + hist.cumsum(1)
    direct = (xm[:, :, None] <= mids[:, None, :]).sum(1)
    return torch.where(ordered[:, None], cum, direct), ordered


def walk4(mids, c, k, lo, hi, clo):
    """Four rounds of the binary search from the node counts c [P, 15]."""
    node = torch.full_like(k, 7)
    for step in (4, 2, 1, 0):
        m = torch.gather(mids, 1, node[:, None])[:, 0]
        cn = torch.gather(c, 1, node[:, None])[:, 0]
        ge = cn >= k
        hi = torch.where(ge, m, hi)
        lo = torch.where(ge, lo, m)
        clo = torch.where(ge, clo, cn)
        node = torch.where(ge, node - step, node + step)
    return lo, hi, clo


def four_round_search(xm, k, lo0, hi0, passes=None, start=None):
    """6 passes of 4 rounds for the k-th order statistic of xm [P, N]
    (or the given passes from start = (lo, hi, clo)); returns the bracket
    (lo, hi), the count below it and whether every pass's tree was
    ordered."""
    lo, hi, clo = start if start else (lo0.clone(), hi0.clone(),
                                       torch.zeros_like(k))
    all_ordered = torch.ones_like(k, dtype=torch.bool)
    for _ in range(stats.BISECT_ROUNDS // LEVELS if passes is None
                   else passes):
        mids = tree(lo, hi)
        c, ordered = node_counts(xm, lo, hi, clo, mids)
        all_ordered &= ordered
        lo, hi, clo = walk4(mids, c, k, lo, hi, clo)
    return lo, hi, clo, all_ordered


def one_pass_pin(xm, lo, hi, clo, k):
    """The pin from (smallest member, its multiplicity, next distinct
    member) of each bracket; every value is <= +inf."""
    inf = torch.tensor(float("inf"))
    inb = (xm > lo[:, None]) & (xm <= hi[:, None])
    m1 = torch.where(inb, xm, inf).amin(1)
    cnt = (inb & (xm == m1[:, None])).sum(1)
    m2 = torch.where(inb & (xm > m1[:, None]), xm, inf).amin(1)
    c1 = torch.where(torch.isinf(m1), xm.shape[1], clo + cnt)
    return torch.where(c1 >= k, m1, torch.where(torch.isfinite(m2), m2, hi))


def _plane(case, rng):
    n = 4096
    x = rng.normal(0, 1, n)
    if case == "heavy_duplicates":
        x = np.round(x * 3) / 3
    elif case == "constant":
        x = np.full(n, 2.5)
    elif case == "two_values":
        x = np.where(rng.random(n) < 0.5, -1.0, 7.0)
    elif case == "n1":
        x = np.zeros(n)
        x[17] = 3.25
    elif case == "n2":
        x = np.zeros(n)
        x[5], x[900] = -0.5, 0.75
    elif case == "near_1e30":
        x = 1e30 * (1 + x * 1e-3)
    elif case == "subnormal":
        x = (rng.integers(1, 40, n) * 1e-45) * np.where(rng.random(n) < 0.3,
                                                         -1, 1)
    elif case == "all_negative":
        x = -np.abs(x) - 1e-3
    elif case == "near_max":     # lo + hi overflows f32: direct counts
        x = 3.0e38 + np.round(x * 8) * 1e36
    elif case == "masked_band":
        x[: n // 3] = np.nan
        x[n // 3: n // 2] = 0.0
    return torch.from_numpy(x.astype(np.float32))


K5_CASES = ["noise", "heavy_duplicates", "constant", "two_values", "n1",
            "n2", "near_1e30", "subnormal", "all_negative", "near_max",
            "masked_band"]


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("case", K5_CASES)
def test_four_round_search_equals_binary_search(monkeypatch, case, clip):
    """Brackets bit-equal to _order_stat_pair's 24-round binary search,
    pinned k1-th and k2-th values equal to its pinned values; with clip,
    on a kept set narrowed to [-0.5, 0.5] of the plane's range (masked
    values are +inf, as the plain version's xm)."""
    x = _plane(case, np.random.default_rng(K5_CASES.index(case)))[None]
    m0 = stats.valid_mask(x)
    vmin = torch.where(m0, x, float("inf")).amin(1)
    vmax = torch.where(m0, x, -float("inf")).amax(1)
    span = torch.clamp(vmax - vmin, min=0.0)
    lo0 = vmin - torch.maximum(span, vmin.abs()) * 1e-5 - 1e-30
    keep = m0
    if clip:
        mid = 0.5 * vmin + 0.5 * vmax
        keep = m0 & (x >= mid - 0.25 * span) & (x <= mid + 0.25 * span)
    xm = torch.where(keep, x, float("inf"))
    ni = keep.sum(1).clamp(min=1)
    k1, k2 = (ni + 1) // 2, ni // 2 + 1

    brackets = []
    real_pin = stats._pin

    def spy(xm_, lo, hi, k):
        brackets.append((lo, hi))
        return real_pin(xm_, lo, hi, k)

    monkeypatch.setattr(stats, "_pin", spy)
    ref1, ref2 = stats._order_stat_pair(xm, k1, k2, lo0, vmax)
    for k, ref, (rlo, rhi) in ((k1, ref1, brackets[0]),
                               (k2, ref2, brackets[1])):
        lo, hi, clo, ordered = four_round_search(xm, k, lo0, vmax)
        assert torch.equal(lo.view(torch.int32), rlo.view(torch.int32))
        assert torch.equal(hi.view(torch.int32), rhi.view(torch.int32))
        assert torch.equal(clo, (xm <= lo[:, None]).sum(1))
        got = one_pass_pin(xm, lo, hi, clo, k)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
        assert bool(ordered.all()) == (case != "near_max")


def kernel_moments(v):
    """The f64 sums (of x, of x * x) of the kept values v [P, N] (0 where
    not kept) as the kernel takes them with cuda_stats.plan's cluster and
    block for N values: each thread's float4s in order, the warp's
    butterfly, the block's warps in order, the cluster's blocks in order."""
    p, n = v.shape
    _, cluster, threads = cuda_stats.plan(n)
    chunk = (-(-n // cluster) + 3) // 4 * 4
    d = torch.zeros(p, cluster * chunk, dtype=torch.float64)
    d[:, :n] = v.double()
    # [P, block, iteration, thread, 4]: thread t takes float4s t, t + T, ...
    iters = -(-chunk // (4 * threads))
    d = torch.nn.functional.pad(d.reshape(p, cluster, chunk),
                                (0, iters * 4 * threads - chunk))
    d = d.reshape(p, cluster, iters, threads, 4)
    sums = []
    for x in (d, d * d):
        t = torch.zeros(p, cluster, threads, dtype=torch.float64)
        for it in range(iters):
            for e in range(4):
                t = t + x[:, :, it, :, e]
        t = t.reshape(p, cluster, threads // 32, 32)
        for o in (16, 8, 4, 2, 1):      # butterfly: t[l] + t[l ^ o]
            t = t + t[..., torch.arange(32) ^ o]
        t = t[..., 0]
        acc = t[:, :, 0]
        for w in range(1, threads // 32):
            acc = acc + t[:, :, w]
        tot = acc[:, 0]
        for b in range(1, cluster):
            tot = tot + acc[:, b]
        sums.append(tot)
    return sums


def kernel_clip_stats(values, sigma_low, sigma_up, maxiters=5, history=None):
    """The kernel's clip loop on planes [P, H, W]: a later stats_of's first
    pass (same tree over (lo0, vmax]) takes the previous counts less those
    of the values the kept set lost; then five more passes and the
    one-pass pin; the moments by `kernel_moments`.  Returns (stats [P, 5]
    = mean, median, std, lower, upper; final kept count [P]); history
    collects each stats_of's (n, median, mean, std)."""
    history = [] if history is None else history
    inf = float("inf")
    p = values.shape[0]
    x = values.reshape(p, -1).float()
    m0 = stats.valid_mask(x)
    vmin = torch.where(m0, x, inf).amin(1)
    vmax = torch.where(m0, x, -inf).amax(1)
    span = torch.clamp(vmax - vmin, min=0.0)
    lo0 = vmin - torch.maximum(span, vmin.abs()) * 1e-5 - 1e-30
    lo_acc, up_acc = torch.full_like(vmin, -inf), torch.full_like(vmin, inf)
    lower, upper = lo_acc, up_acc
    zero = torch.zeros(p, dtype=torch.int64)
    mids = tree(lo0, vmax)
    prev_c = prev_keep = None
    for it in range(maxiters + 1):
        keep = m0 & (x >= lo_acc[:, None]) & (x <= up_acc[:, None])
        xm = torch.where(keep, x, inf)
        n = keep.sum(1)
        ni = n.clamp(min=1)
        c, ordered = node_counts(xm, lo0, vmax, zero, mids)
        if it > 0:
            lost = torch.where(prev_keep & ~keep, x, float("nan"))
            c_lost, _ = node_counts(lost, lo0, vmax, zero, mids)
            c = torch.where(ordered[:, None], prev_c - c_lost, c)
        prev_c, prev_keep = c, keep
        r = []
        for k in ((ni + 1) // 2, ni // 2 + 1):
            start = walk4(mids, c, k, lo0, vmax, zero)
            lo, hi, clo, _ = four_round_search(xm, k, lo0, vmax, 5, start)
            r.append(one_pass_pin(xm, lo, hi, clo, k))
        med = 0.5 * (r[0] + torch.where(ni // 2 + 1 == (ni + 1) // 2, r[0],
                                         r[1]))
        s1, s2 = kernel_moments(torch.where(keep, x, 0.0))
        m = s1 / ni.double()
        mean = m.float()
        std = torch.sqrt(torch.clamp(s2 / ni.double() - m * m,
                                     min=0.0).float())
        history.append((n, med, mean, std))
        if it < maxiters:
            lower, upper = med - sigma_low * std, med + sigma_up * std
            lo_acc = torch.maximum(lo_acc, lower)
            up_acc = torch.minimum(up_acc, upper)
    return torch.stack([mean, med, std, lower, upper], dim=1), n


@pytest.mark.parametrize("sigmas", [(3.0, 3.0), (0.0, 20.0), (1.0, 20.0)])
def test_kernel_clip_loop_equals_plain(sigmas):
    """The whole clip loop, incremental first passes included: medians and
    final kept counts equal clip_stats_plain's on noise, a bright source,
    heavy duplicates, a masked band and a constant plane; and once a
    plane's kept count repeats, its statistics repeat too (the kernel
    stops its loop there)."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (6, 48, 64)).astype(np.float32)
    x[1, 20:26, 30:36] += 400.0
    x[2] = np.round(x[2] * 4) / 4
    x[3, :16] = np.nan
    x[4] = 1.5
    x[5, :, :3] = 0.0
    x = torch.from_numpy(x)
    history = []
    got, n = kernel_clip_stats(x, *sigmas, history=history)
    ref_stats, ref_counts = stats.clip_stats_plain(x, None, *sigmas)
    assert torch.equal(n, ref_counts[:, 1].long())
    assert torch.equal(got[:, 1].contiguous().view(torch.int32),
                       ref_stats[:, 1].contiguous().view(torch.int32))
    # the kernel stops a plane's loop when its kept count repeats: from
    # there every stats_of repeats bit for bit
    for (n0, *st0), (n1, *st1) in zip(history, history[1:]):
        same = n1 == n0
        for a, b in zip(st0, st1):
            assert torch.equal(a[same].view(torch.int32),
                               b[same].view(torch.int32))


def _script(name):
    """A module of scripts/ by name."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("plane", [7, 13])
def test_kernel_clip_loop_on_the_pinned_planes(plane):
    """The two planes where the kernel once kept 5 and 1 pixels fewer than
    the plain version at sigmas (1, 20) (the parity phase's K5 planes when
    its K3 check draws every shape and edge case), rebuilt from the same
    seeded draws: the kernel's clip loop, moments in its order, meets
    cuda_stats.stats_mismatch against clip_stats_plain, with equal kept
    counts and statistics equal to the bit."""
    probe = _script("torch_k5_kept_probe")
    x = cs.mosaic_planes("cpu", probe.parity_generator("k3-shapes-edges"))
    x = x[plane:plane + 1].contiguous()
    got, n = kernel_clip_stats(x, 1.0, 20.0)
    ref = stats.clip_stats_plain(x, None, 1.0, 20.0)
    counts = torch.stack([stats.valid_mask(x).reshape(1, -1).sum(1), n],
                         dim=1).int()
    assert cuda_stats.stats_mismatch((got, counts), ref) is None
    assert torch.equal(counts, ref[1])
    assert torch.equal(got.view(torch.int32), ref[0].view(torch.int32))


def test_four_round_tree_reaches_collapsed_brackets():
    """Adjacent-float brackets, where midpoints round onto an end: the
    tree stays ordered (non-decreasing) and the walk equals the search."""
    base = torch.tensor([1.0], dtype=torch.float32)
    nxt = torch.nextafter(base, torch.tensor([2.0]))
    x = torch.cat([base.repeat(7), nxt.repeat(9)])[None]
    k = torch.tensor([8])
    mids = tree(base, nxt)
    assert bool((mids[:, :-1] <= mids[:, 1:]).all())
    assert set(mids.flatten().tolist()) <= {base.item(), nxt.item()}
    lo, hi, clo, ordered = four_round_search(x, k, base - 1.0, nxt)
    lo_b, hi_b = base - 1.0, nxt.clone()
    for _ in range(stats.BISECT_ROUNDS):
        m = 0.5 * (lo_b + hi_b)
        ge = (x <= m[:, None]).sum(1) >= k
        lo_b, hi_b = torch.where(ge, lo_b, m), torch.where(ge, m, hi_b)
    assert torch.equal(lo, lo_b) and torch.equal(hi, hi_b)
    assert bool(ordered.all())
    assert one_pass_pin(x, lo, hi, clo, k).item() == nxt.item()


@pytest.mark.parametrize("hw,route,cluster", [
    (512 * 512, "cluster", 16), (256 * 512, "cluster", 8),
    (640 * 640, "cluster", 16), (132 * 132, "cluster", 2),
    (33 * 47, "cluster", 1), (2048 * 2048, "stream", 16),
    (16 * cuda_stats.MAX_BLOCK_VALUES, "cluster", 16),
    (16 * cuda_stats.MAX_BLOCK_VALUES + 1, "stream", 16)])
def test_stats_route_by_size(hw, route, cluster):
    """The route and cluster size come from the plane's size alone, and a
    block of the cluster route never holds more than its share."""
    assert cuda_stats.plan(hw, 16)[:2] == (route, cluster)
    if route == "cluster":
        chunk = (-(-hw // cluster) + 3) // 4 * 4
        assert chunk <= cuda_stats.MAX_BLOCK_VALUES


# ---------------------------------------------------------------- K1


def kill_words(boxes, valid, thr):
    """[K, words] python-int kill mask: bit l of word w of row j when j,
    if alive, kills i = 32 w + l (the plain version's suppression)."""
    k = boxes.shape[0]
    words = -(-k // 32)
    iou = iou_matrix(boxes, boxes)
    js = torch.arange(k)
    kill = ((iou > torch.tensor(thr)) & (js[:, None] < js[None, :])
            & valid[:, None] & valid[None, :])
    out = [[0] * words for _ in range(k)]
    for j, i in kill.nonzero().tolist():
        out[j][i >> 5] |= 1 << (i & 31)
    return out


def word_scan(mask, valid):
    """The scan kernel's steps on one image: per 32-row block, the removed
    word of the block, the rows' diagonal words and a chain of 32 greedy
    decisions, then the kept rows' later words ORed in."""
    k = len(mask)
    words = -(-k // 32)
    removed = [0] * words
    alive = [False] * k
    for c in range(words):
        rows = range(32 * c, min(32 * c + 32, k))
        vb = sum(1 << (r - 32 * c) for r in rows if valid[r])
        diag = [mask[r][c] for r in rows]
        rw = removed[c]
        for i, d in enumerate(diag):
            if (vb & ~rw) >> i & 1:
                rw |= d
        keep = vb & ~rw
        for i, r in enumerate(rows):
            alive[r] = bool(keep >> i & 1)
            if keep >> i & 1:
                for w in range(c + 1, words):
                    removed[w] |= mask[r][w]
    return torch.tensor(alive)


def mask_layout(k, words, rows):
    """The mask launch's index arithmetic: block b of nb = ceil(k / rows)
    takes rows b, b + nb, ..., one (row, word) a thread; shared memory
    holds column 32 u + l at position l * words + u.  Returns
    {(j, w): [column read for each l]} over the threads that write."""
    nb = -(-k // rows)
    cols = [32 * (p % words) + p // words for p in range(32 * words)]
    out = {}
    for blk in range(nb):
        for t in range(rows * words):
            j, w = blk + nb * (t // words), t % words
            if j >= k or w < (j >> 5):
                continue
            assert (j, w) not in out
            assert cols[(j & 31) * words + (j >> 5)] == j
            out[(j, w)] = [cols[l_ * words + w] for l_ in range(32)]
    return out


def _boxes(case, k, rng):
    cx, cy = rng.random((2, k)) * (40 + 3 * k)
    w, h = rng.random((2, k)) * 30 + 2
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    valid = rng.random(k) > 0.1
    if case == "chains":            # A kills B, B would have killed C
        for a in range(0, k - 2, 3):
            boxes[a:a + 3] = [[0, 0, 10, 10], [0, 0, 10, 16], [0, 0, 10, 24]]
            boxes[a:a + 3] += 50.0 * a
        valid[:] = True
    elif case == "all_invalid":
        valid[:] = False
    elif case == "overlapping":
        boxes = np.array([10, 10, 60, 60]) + rng.random((k, 4)) * 4
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(valid))


@pytest.mark.parametrize("k", [1, 31, 33, 100])
@pytest.mark.parametrize("case", ["random", "chains", "all_invalid",
                                  "overlapping"])
def test_word_scan_equals_suppress_plain(case, k):
    boxes, valid = _boxes(case, k, np.random.default_rng(k))
    ref = cuda_nms.suppress_plain(boxes[None], valid[None], 0.5)[0]
    got = word_scan(kill_words(boxes, valid, 0.5), valid.tolist())
    assert torch.equal(got, ref)
    if case == "chains" and k >= 3:    # greedy, not one-pass, suppression
        assert ref[:3].tolist() == [True, False, True]


@pytest.mark.parametrize("k", [1, 33, 100, 512, 2048])
def test_mask_layout_covers_every_needed_word(k):
    """Every (row, word) the scan reads (the diagonal word and later
    ones) is written by exactly one thread, reading columns 32 w .. 32 w
    + 31 in order."""
    words = -(-k // 32)
    rows = max(1, min(32, 512 // words))
    out = mask_layout(k, words, rows)
    need = {(j, w) for j in range(k) for w in range(j >> 5, words)}
    assert set(out) == need
    for (j, w), cols in out.items():
        assert cols == list(range(32 * w, 32 * w + 32))


# ---------------------------------------------------------------- K6


def warp_scan(hist):
    """The kernel's inclusive scan of [256] counts: each warp of 32 bins
    scans its own, then adds the totals of the warps before it."""
    warps = hist.reshape(NBINS // 32, 32).cumsum(dim=1)
    before = torch.cat([torch.zeros(1, dtype=hist.dtype),
                        warps[:, -1].cumsum(0)[:-1]])
    return (warps + before[:, None]).reshape(-1), warps[:, -1].sum()


def cluster_histeq(planes, cluster):
    """K6's cluster route: each plane in `cluster` parts of a 4-aligned
    chunk (the last parts may be short or empty), partial min/max/NaN and
    histograms combined over the parts, the warp scan, the apply."""
    p = planes.shape[0]
    flat = planes.reshape(p, -1).float()
    hw = flat.shape[1]
    chunk = (-(-hw // cluster) + 3) // 4 * 4
    out = torch.empty_like(flat)
    for i in range(p):
        parts = [flat[i, r * chunk:(r + 1) * chunk] for r in range(cluster)]
        nan = any(bool(v.isnan().any()) for v in parts)
        real = [v[~v.isnan()] for v in parts]
        lo = min((float(v.min()) for v in real if len(v)), default=np.inf)
        hi = max((float(v.max()) for v in real if len(v)), default=-np.inf)
        vmin = torch.tensor(np.nan if nan else lo, dtype=torch.float32)
        span = (torch.tensor(1.0) if nan or not hi > lo
                else torch.tensor(hi, dtype=torch.float32) - vmin)
        hist = sum(torch.bincount(
            _to_index((v - vmin) / span * NBINS, NBINS - 1),
            minlength=NBINS) for v in parts)
        cum, total = warp_scan(hist)
        cdf = cum.float() / total.float()
        step = span / NBINS
        c0 = vmin + 0.5 * step
        for r, v in enumerate(parts):
            pos = torch.clamp((v - c0) / step, 0.0, float(NBINS - 1))
            i0 = _to_index(pos, NBINS - 2)
            f = torch.clamp(pos - i0.float(), 0.0, 1.0)
            out[i, r * chunk:r * chunk + len(v)] = (cdf[i0] * (1.0 - f)
                                                    + cdf[i0 + 1] * f)
    return out.reshape(planes.shape)


def _histeq_planes(p, h, w, seed):
    """Noise planes and the edge cases: a NaN, +-inf, a constant plane,
    all values equal but one, a bright source."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (p, h, w)).astype(np.float32)
    cases = [("nan", lambda a: a.__setitem__((h // 2, 3), np.nan)),
             ("inf", lambda a: a.__setitem__((1, 1), np.inf)),
             ("-inf", lambda a: a.__setitem__((2, 2), -np.inf)),
             ("const", lambda a: a.fill(7.0)),
             ("all but one", lambda a: (a.fill(2.0),
                                        a.__setitem__((h - 1, w - 1), 5.0))),
             ("source", lambda a: a.__setitem__(
                 (slice(h // 3, h // 3 + 4), slice(w // 2, w // 2 + 4)),
                 a[h // 3:h // 3 + 4, w // 2:w // 2 + 4] + 300.0))]
    for i, (_, fill) in enumerate(cases[:p]):
        fill(x[i])
    return torch.from_numpy(x)


@pytest.mark.parametrize("shape,cluster", [
    ((6, 64, 64), 16), ((6, 64, 64), 1), ((6, 33, 47), 4), ((6, 5, 7), 16),
    ((1, 80, 80), 16), ((6, 132, 132), 2)])
def test_cluster_histeq_equals_plain(shape, cluster):
    x = _histeq_planes(*shape, seed=sum(shape) + cluster)
    got = cluster_histeq(x, cluster)
    ref = equalize_hist(x)
    assert torch.equal(got.isnan(), ref.isnan())
    assert torch.equal(got.nan_to_num(), ref.nan_to_num())
    assert bool(got[0].isnan().all())          # a NaN poisons its plane


def test_warp_scan_equals_cumsum():
    hist = torch.from_numpy(np.random.default_rng(0).integers(
        0, 5000, NBINS)).int()
    cum, total = warp_scan(hist)
    assert torch.equal(cum, hist.cumsum(0).int())
    assert int(total) == int(hist.sum())


@pytest.mark.parametrize("hw,route,cluster", [
    (512 * 512, "cluster", 16), (640 * 640, "cluster", 16),
    (132 * 132, "cluster", 2), (96 * 100, "cluster", 1),
    (33 * 47, "cluster", 1), (256 * 512, "cluster", 8),
    (16 * cuda_histeq.MAX_BLOCK_VALUES, "cluster", 16),
    (16 * cuda_histeq.MAX_BLOCK_VALUES + 1, "stream", 16),
    (2048 * 2048, "stream", 16)])
def test_histeq_route_by_size(hw, route, cluster):
    """K6's route and cluster size come from the plane's size alone, and
    a block of the cluster route never holds more than its share."""
    assert cuda_histeq.plan(hw)[:2] == (route, cluster)
    if route == "cluster":
        chunk = (-(-hw // cluster) + 3) // 4 * 4
        assert chunk <= cuda_histeq.MAX_BLOCK_VALUES


# ---------------------------------------------------------------- K7


def _tile_cols(n, tsize, grid):
    """Per position of an axis of n: its tile, and the tile of the padded
    position that reflects onto it (-1 where none)."""
    pad = grid * tsize - n
    i = torch.arange(n)
    refl = (i >= n - 1 - pad) & (i <= n - 2)
    return i // tsize, torch.where(refl, (2 * (n - 1) - i) // tsize, -1)


def cluster_clahe(planes, cluster, clip_limit=0.03, grid=clahe.GRID):
    """K7's cluster route: each plane in blocks of cuda_clahe.layout's rows;
    the blocks' min/max/NaN combined; each block's pixels binned once and
    counted at their padded positions into its tile rows (within the
    layout's window), the counts added into the received counts of every
    block whose table rows hold them; each block's tables built from what
    it received; the blend from them with per-row and per-column taps."""
    p, h, w = planes.shape
    th, tw = clahe.tile_size(h, w, grid)
    rows, win, _ = cuda_clahe.layout(h, w, cluster, grid)
    windows = cuda_clahe.block_windows(h, w, rows, grid)
    assert len(windows) <= cluster
    tile_len = grid * clahe.NBINS
    ty, ry = _tile_cols(h, th, grid)
    tx, rx = _tile_cols(w, tw, grid)
    y0, y1, fy = clahe._blend_coords(h, th, grid, "cpu")
    x0, x1, fx = clahe._blend_coords(w, tw, grid, "cpu")
    out = torch.empty_like(planes)
    for i in range(p):
        parts = [planes[i, r0:r0 + rows] for r0 in range(0, h, rows)]
        nan = any(bool(v.isnan().any()) for v in parts)
        real = [v[~v.isnan()] for v in parts]
        lo = min(float(v.min()) for v in real if len(v)) if not nan else 0.0
        hi = max(float(v.max()) for v in real if len(v)) if not nan else 0.0
        vmin = torch.tensor([np.nan if nan else lo], dtype=torch.float32)
        span = (torch.tensor([1.0]) if nan or not hi > lo
                else torch.tensor([hi], dtype=torch.float32) - vmin)
        bins = [clahe.bin_index(v[None], vmin, span)[0] for v in parts]
        recv = torch.zeros(len(windows), win * tile_len, dtype=torch.int64)
        for b, ((ha, hb), _) in enumerate(windows):
            assert hb - ha + 1 <= win
            ys = slice(b * rows, b * rows + len(bins[b]))
            local = torch.zeros((hb - ha + 1) * tile_len, dtype=torch.int64)
            for trow in (ty[ys], ry[ys]):
                for tcol in (tx, rx):
                    on = (trow >= 0)[:, None] & (tcol >= 0)[None, :]
                    idx = (((trow - ha)[:, None] * grid + tcol[None, :])
                           * clahe.NBINS + bins[b])
                    local.index_add_(0, idx[on], torch.ones_like(idx[on]))
            for s in local.nonzero().flatten().tolist():
                k = ha + s // tile_len
                for q, (_, (ca, cb)) in enumerate(windows):
                    if ca <= k <= cb:
                        recv[q, (k - ca) * tile_len + s % tile_len] += local[s]
        for b, (_, (ca, cb)) in enumerate(windows):
            assert cb - ca + 1 <= win
            counts = recv[b, :(cb - ca + 1) * tile_len].reshape(
                -1, clahe.NBINS)
            assert bool((counts.sum(1) == th * tw).all())
            ys = slice(b * rows, b * rows + len(bins[b]))
            cdf = clahe.cdf_tables(counts.float(), th * tw,
                                   clip_limit).reshape(-1)

            def look(trow, tcol):
                idx = (((trow[ys] - ca)[:, None] * grid + tcol[None, :])
                       * clahe.NBINS + bins[b])
                return cdf[idx]

            v00 = look(y0, x0)
            top = v00 + fx[None, :] * (look(y0, x1) - v00)
            v10 = look(y1, x0)
            bot = v10 + fx[None, :] * (look(y1, x1) - v10)
            out[i, ys] = top + fy[ys, None] * (bot - top)
    return out


def _clahe_planes(p, h, w, seed):
    """Noise with a bright source a plane; where p allows, an all-zero
    plane, a plane holding a NaN and a constant plane."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (p, h, w)).astype(np.float32)
    x[:, h // 3:h // 3 + 6, w // 2:w // 2 + 6] += 150.0
    for i, fill in enumerate([0.0, None, 7.0][:p - 1]):
        if fill is None:
            x[i + 1, h // 2, 3] = np.nan
        else:
            x[i + 1] = fill
    return torch.from_numpy(x)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(2, 132, 132), (1, 96, 100),
                                   (1, 256, 256), (4, 33, 47)])
def test_cluster_clahe_equals_plain(shape, cluster):
    """Blocks whose rows split tile rows, the pad's double counts in both
    axes, owner tiles spread over the cluster and per-row taps, bit-equal
    to the plain version at clip limits 0.03 and 0.01."""
    x = _clahe_planes(*shape, seed=sum(shape) + cluster)
    for clip_limit in (0.03, 0.01):
        got = cluster_clahe(x, cluster, clip_limit)
        ref = clahe.equalize_adapthist_plain(x, clip_limit)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("shape,route,cluster,rows", [
    ((132, 132), "cluster", 2, 66), ((640, 640), "cluster", 16, 40),
    ((96, 100), "cluster", 1, 96), ((128, 256), "cluster", 2, 64),
    ((33, 47), "cluster", 1, 33), ((512, 512), "cluster", 16, 32),
    ((800, 800), "stream", 0, 0), ((1024, 1024), "stream", 0, 0),
    ((2048, 2048), "stream", 0, 0)])
def test_clahe_route_by_size(shape, route, cluster, rows):
    """K7's route, cluster size and rows a block come from the plane's size
    alone; a block of the cluster route fits its shared memory, and every
    block's tile rows fit its table buffer."""
    got = cuda_clahe.plan(*shape)
    assert got[:3] == (route, cluster, rows)
    if route == "cluster":
        r, win, smem = cuda_clahe.layout(*shape, cluster)
        assert (r, win) == got[2:]
        assert smem <= cuda_clahe.SMEM_BYTES
        assert rows * cluster >= shape[0]
        for (ha, hb), (ca, cb) in cuda_clahe.block_windows(*shape, rows):
            assert 0 <= ha <= hb < clahe.GRID and 0 <= ca <= cb < clahe.GRID
            assert max(hb - ha, cb - ca) < win
    else:
        assert cuda_clahe.layout(*shape, cuda_clahe.CLUSTER)[2] > (
            cuda_clahe.SMEM_BYTES)


# ---------------------------------------------------------------- K8


def _lerp(a0, a1, f):
    return a0 * (1.0 - f) + a1 * f


def row_route(imgs, k0, f, pad_val):
    """K8's row route on a contiguous canvas: taps j + k*C and j + (k+1)*C
    of each row of W*C floats, out of frame outside [0, W*C)."""
    b, h, w, c = imgs.shape
    n = w * c
    rows = imgs.reshape(b * h, n)
    a = torch.arange(n)[None] + (k0.reshape(-1).long() * c)[:, None]
    taps = []
    for t in (a, a + c):
        inside = (t >= 0) & (t < n)
        taps.append(torch.where(inside, rows.gather(1, t.clamp(0, n - 1)),
                                torch.tensor(pad_val)))
    return _lerp(*taps, f.reshape(-1, 1)).reshape(imgs.shape)


def column_route(canvas, k0, f, pad_val, xw, yh):
    """K8's column route on a canvas [B, N, R, C] shifted along N (one
    shift per column): strips of xw columns, bands of yh rows, the band's
    source rows [lo, hi] staged when they fit in yh + xw + 2 rows.
    Returns the output and how many bands were staged and read directly."""
    b, n, r, c = canvas.shape
    cap = yh + xw + 2
    out = torch.empty_like(canvas)
    staged = direct = 0
    for bb in range(b):
        for x0 in range(0, r, xw):
            xs = min(xw, r - x0)
            k = k0[bb, x0:x0 + xs].long()
            fr = f[bb, x0:x0 + xs][None, :, None]
            for y0 in range(0, n, yh):
                ys = min(yh, n - y0)
                lo = max(0, y0 + int(k.min()))
                hi = min(n - 1, y0 + ys + int(k.max()))
                fits = hi - lo + 1 <= cap
                staged += fits
                direct += not fits
                src = (canvas[bb, lo:hi + 1, x0:x0 + xs] if fits
                       else canvas[bb, :, x0:x0 + xs])
                base = lo if fits else 0
                y = torch.arange(y0, y0 + ys)[:, None] + k[None]   # [ys, xs]
                taps = []
                for t in (y, y + 1):
                    inside = (t >= 0) & (t < n)
                    i = (t - base).clamp(0, src.shape[0] - 1)
                    if fits:     # every in-frame tap is a staged row
                        assert bool(((t - base)[inside] < src.shape[0]).all())
                    v = (src[i, torch.arange(xs)[None]] if len(src)
                         else torch.zeros(ys, xs, c))   # no tap in frame
                    taps.append(torch.where(inside[..., None], v,
                                            torch.tensor(pad_val)))
                out[bb, y0:y0 + ys, x0:x0 + xs] = _lerp(*taps, fr)
    return out, staged, direct


def _canvas(b, s, c, seed):
    return torch.from_numpy(np.random.default_rng(seed).random(
        (b, s, s, c), dtype=np.float32))


def _shear_shifts(b, s, seed):
    """The augmentation's shifts tan(r) * (i - centre), |r| <= 45 deg."""
    r = (np.random.default_rng(seed).random(b) * 2 - 1) * np.pi / 4
    r[0] = np.pi / 4
    ys = np.arange(s, dtype=np.float32) - (s - 1) / 2
    return torch.from_numpy((np.tan(r)[:, None] * ys[None]).astype(np.float32))


@pytest.mark.parametrize("c,w", [(3, 20), (1, 21), (3, 21)])
def test_row_route_equals_plain(c, w):
    """The row route's flat index math, shifts at the clip limits and past
    them, W*C a multiple of 4 and not."""
    imgs = _canvas(2, w, c, w)
    pad = w // 2 + 2
    shifts = (torch.rand(2, w, generator=torch.Generator().manual_seed(c))
              * 2 - 1) * (pad + 3)
    shifts[0, :3] = torch.tensor([-pad, pad - 1.0, 0.5])
    k0, f = cuda_shift._split_shifts(shifts, pad)
    for pad_val in (114 / 255, 0.0):
        assert torch.equal(row_route(imgs, k0, f, pad_val),
                           cuda_shift.row_shift_plain(imgs, shifts, pad,
                                                      pad_val))


@pytest.mark.parametrize("xw,yh", [(16, 64), (4, 8), (8, 16), (3, 5)])
@pytest.mark.parametrize("c", [3, 1])
def test_column_route_equals_plain_on_the_view(xw, yh, c):
    """The column route's tiles on the y-shear (the transposed view of the
    canvas): the augmentation's shears are staged; random shifts, far
    apart within a strip, read device memory; both bit-equal."""
    s = 40 if yh < 32 else 120      # more rows than a band stages
    canvas = _canvas(3, s, c, xw * yh)
    pad = s // 2 + 2
    view = canvas.transpose(1, 2)
    rand = (torch.rand(3, s, generator=torch.Generator().manual_seed(yh))
            * 2 - 1) * (pad + 3)
    rand[0, :2] = torch.tensor([-pad, pad - 1.0])
    for shifts, expect in ((_shear_shifts(3, s, xw), "staged"),
                           (rand, "direct")):
        k0, f = cuda_shift._split_shifts(shifts, pad)
        ref = cuda_shift.row_shift_plain(view, shifts, pad, 114 / 255)
        got, staged, direct = column_route(canvas, k0, f, 114 / 255, xw, yh)
        assert torch.equal(got.transpose(1, 2), ref)
        if expect == "staged":
            assert direct == 0
        else:
            assert direct > 0


@pytest.mark.parametrize("shape,make,want", [
    ((2, 6, 5, 3), lambda t: t, "row"),
    ((2, 6, 5, 3), lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     "column"),
    ((2, 6, 5, 1), lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     "column"),
    ((2, 1, 5, 3), lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     "row"),
    ((1, 6, 5, 3), lambda t: t.permute(0, 2, 1, 3).contiguous().permute(
        0, 2, 1, 3), "column"),
    ((2, 6, 5, 3), lambda t: t.permute(0, 1, 3, 2).contiguous().permute(
        0, 1, 3, 2), ValueError),
    ((2, 6, 5, 3), lambda t: t.permute(1, 0, 2, 3).contiguous().permute(
        1, 0, 2, 3), ValueError),
    ((2, 6, 5, 3), lambda t: t[:, :, ::2], ValueError)])
def test_shift_route_from_strides(shape, make, want):
    """K8's route comes from the strides alone: a contiguous canvas takes
    the row route, the transposed view of one the column route; a channel
    stride that is not 1, or any other layout, is refused."""
    t = make(torch.zeros(shape))
    if want is ValueError:
        with pytest.raises(ValueError):
            cuda_shift.route(t.shape, t.stride())
    else:
        assert cuda_shift.route(t.shape, t.stride()) == want


# ---------------------------------------------------------------- K3


def cluster_zscale_minmax(planes, vlims, cluster, segments, norm_min=0.0,
                          norm_max=1.0):
    """K3's cluster route: each plane in `cluster` parts of a 4-aligned
    chunk, each part in `segments` segments (the last parts and segments
    may be short or empty); the stretch of each segment in place, the
    parts' masked (min, max) combined, then each part normalised on its
    own.  Returns (out, zlims) as zscale_minmax_plain does."""
    p = planes.shape[0]
    flat = planes.reshape(p, -1)
    hw = flat.shape[1]
    chunk = cuda_preproc.chunk(hw, cluster)
    out = torch.empty_like(flat)
    zlims = torch.empty((p, 2))
    for i in range(p):
        vmin, vmax = vlims[i, 0], vlims[i, 1]
        parts = []
        for r in range(cluster):
            part = flat[i, r * chunk:(r + 1) * chunk]
            n = len(part)
            seg = (-(-n // segments) + 3) // 4 * 4
            z = torch.cat([torch.where(
                (v != 0) & torch.isfinite(v), zscale_apply(v, vmin, vmax),
                0.0) for v in (part[j * seg:(j + 1) * seg]
                               for j in range(segments))]) if n else part
            parts.append(z)
        valid = [z[(z != 0) & torch.isfinite(z)] for z in parts]
        lo = min((float(v.min()) for v in valid if len(v)), default=np.inf)
        hi = max((float(v.max()) for v in valid if len(v)), default=-np.inf)
        zlims[i] = torch.tensor([lo, hi])
        lo_t, hi_t = zlims[i, 0], zlims[i, 1]
        span = hi_t - lo_t
        denom = span if span != 0 else torch.tensor(1.0)
        for r, z in enumerate(parts):
            o = (z - lo_t) / denom * (norm_max - norm_min) + norm_min
            out[i, r * chunk:r * chunk + len(z)] = torch.where(
                (z != 0) & torch.isfinite(z), o, 0.0)
    return out.reshape(planes.shape), zlims


@pytest.mark.parametrize("shape,cluster,segments", [
    ((8, 64, 64), 16, 2), ((8, 64, 64), 4, 1), ((8, 64, 64), 3, 8),
    ((7, 33, 47), 4, 3), ((6, 5, 7), 16, 2), ((8, 132, 132), 4, 1),
    ((2, 160, 160), 16, 2)])
@pytest.mark.parametrize("norm", [(0.0, 1.0), (-1.0, 2.0)])
def test_cluster_zscale_minmax_equals_plain(shape, cluster, segments, norm):
    x = cs.preproc_planes("cpu", np.random.default_rng(sum(shape) + cluster),
                          shape)
    vlims = torch.stack(zscale_limits(x), dim=1)
    got, zl = cluster_zscale_minmax(x, vlims, cluster, segments, *norm)
    ref, rzl = cuda_preproc.zscale_minmax_plain(x, vlims, *norm)
    assert torch.equal(zl, rzl)
    assert torch.equal(got, ref)
    valid = (zl[:, 1] > zl[:, 0]) & zl[:, 0].isfinite()
    assert zl[0].tolist() == [np.inf, -np.inf]       # all zero: no valid
    assert not bool(valid[:min(4, len(valid) - 1)].any())
    assert bool(valid[-1])                           # the noise plane


@pytest.mark.parametrize("hw,route,cluster,segments", [
    (640 * 640, "cluster", 16, 2), (132 * 132, "cluster", 4, 1),
    (512 * 512, "cluster", 16, 1), (200 * 160, "cluster", 4, 1),
    (33 * 47, "cluster", 1, 1), (96 * 100, "cluster", 2, 1),
    (800 * 800, "cluster", 16, 3),
    (16 * cuda_preproc.MAX_BLOCK_VALUES, "cluster", 16, 4),
    (16 * cuda_preproc.MAX_BLOCK_VALUES + 1, "stream", 16, 0),
    (1024 * 1024, "stream", 16, 0), (2048 * 2048, "stream", 16, 0)])
def test_preproc_route_by_size(hw, route, cluster, segments):
    """K3's route, cluster size and segments come from the plane's size
    alone; a block of the cluster route holds its part in one buffer within
    the 227 KB of shared memory an H100 block may use."""
    assert cuda_preproc.plan(hw) == (route, cluster, segments)
    if route == "cluster":
        assert cuda_preproc.chunk(hw, cluster) <= cuda_preproc.MAX_BLOCK_VALUES
        assert cuda_preproc.chunk(hw, cluster) * 4 <= 227 * 1024 - 1024


# ---------------------------------------------------------------- K4


def strided_upsample_backward(g, vec_bytes):
    """K4's backward indexing: gx row (b, y), thread t -> output pixel
    t // cv, vector t % cv of L = vec_bytes / itemsize channels; the
    window's four vectors read from g's storage at its data offset plus
    b*sb + 2y*sh + 2x*sw (+ sw, + sh) + c*L; each lane summed in f32 as
    ((g00 + g01) + g10) + g11 and rounded once."""
    b, c, h2, w2 = g.shape
    h, w = h2 // 2, w2 // 2
    sb, _, sh, sw = g.stride()
    lanes = vec_bytes // g.element_size()
    cv = c // lanes
    store = g.untyped_storage()
    flat = torch.empty(0, dtype=g.dtype).set_(store).float()
    t = torch.arange(w * cv)
    xo, cvec = t // cv, t % cv
    gx = torch.empty(b, h, w * cv, lanes)
    for bi in range(b):
        for y in range(h):
            base = (g.storage_offset() + bi * sb + 2 * y * sh + 2 * xo * sw
                    + cvec * lanes)[:, None] + torch.arange(lanes)
            g00, g01, g10, g11 = (flat[base + d] for d in (0, sw, sh,
                                                          sh + sw))
            gx[bi, y] = ((g00 + g01) + g10) + g11
    return gx.reshape(b, h, w, c).to(g.dtype).permute(0, 3, 1, 2)


def _concat_grad(width, dtype, seed):
    g = torch.randn(2, width, 6, 8, generator=torch.Generator().manual_seed(
        seed)).to(dtype)
    return g.contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width,offset,c", [
    (64, 0, 32), (64, 32, 32), (48, 16, 32), (64, 3, 32), (64, 4, 32),
    (40, 0, 30), (8, 1, 6), (4, 0, 1)])
def test_strided_backward_on_slices_equals_plain(dtype, width, offset, c):
    """The kernel's indexing on the concat's channel slices (aligned,
    unaligned offsets, odd C), at the vector width backward_plan gives,
    equals the plain backward bit for bit; the plain backward on a slice
    equals it on the slice's contiguous copy."""
    g = _concat_grad(width, dtype, seed=width + offset + c)[:, offset:
                                                             offset + c]
    vb = cuda_upsample.backward_plan(g.shape, g.stride(), g.storage_offset(),
                                     g.element_size())
    ref = cuda_upsample.upsample2x_backward_plain(g)
    assert torch.equal(strided_upsample_backward(g, vb), ref)
    assert torch.equal(cuda_upsample.upsample2x_backward_plain(
        g.contiguous(memory_format=torch.channels_last)), ref)
    assert torch.equal(cuda_upsample.upsample2x_backward_plain(
        g.contiguous()), ref)


@pytest.mark.parametrize("width,offset,c,dtype,want", [
    (1024, 0, 512, torch.bfloat16, 16), (1024, 512, 512, torch.bfloat16, 16),
    (768, 256, 512, torch.bfloat16, 16), (1024, 0, 512, torch.float32, 16),
    (1024, 3, 512, torch.bfloat16, 2), (1024, 3, 512, torch.float32, 4),
    (1024, 4, 512, torch.bfloat16, 8), (1024, 2, 512, torch.float32, 8),
    (520, 0, 510, torch.bfloat16, 4), (520, 0, 510, torch.float32, 8),
    (8, 1, 6, torch.bfloat16, 2), (4, 0, 1, torch.float32, 4)])
def test_upsample_backward_plan(width, offset, c, dtype, want):
    """backward_plan's vector bytes: 16 on yolo11l's neck slices (512 of
    1024 or 768 channels, at channel 0 or past the first input), narrower
    where the offset, C or a stride is not a multiple of 16 bytes, never
    below the element; a channel stride other than 1 is refused."""
    g = torch.zeros(2, width, 4, 6, dtype=dtype).contiguous(
        memory_format=torch.channels_last)[:, offset:offset + c]
    assert cuda_upsample.backward_plan(g.shape, g.stride(),
                                       g.storage_offset(),
                                       g.element_size()) == want
    nchw = torch.zeros(2, 8, 4, 6, dtype=dtype)
    with pytest.raises(ValueError):
        cuda_upsample.backward_plan(nchw.shape, nchw.stride(), 0,
                                    nchw.element_size())
