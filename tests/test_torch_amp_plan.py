"""The streaming bodies of amp's multi-tensor scale (K1,
``csrc/multi_tensor_scale.cu`` ``scale_vec_kernel``) and of SGD (K3,
``csrc/sgd.cu`` ``sgd_vec_kernel``) on the CPU: their plans
(``kernels/optim.py`` ``adam_plan`` at ``kernels/scale.py``
``vector_width``), the heads the wrappers hand the C functions, a model
of the bodies' grid-stride walk, the path the wrappers take, and the
launch tables against the 4 KB kernel parameter limit.

Pure Python: nothing is built and no JAX function is involved (the
kernels' arithmetic is held to JAX's ``multi_tensor_scale``,
``multi_tensor_axpby`` and ``multi_tensor_sgd`` through their plain
versions in ``tests/test_torch_amp_optim.py``). Exact comparisons
throughout: the plans are integer arithmetic.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from apex_tpu_torch.kernels import _checks, optim, registry
from apex_tpu_torch.kernels import scale as ks
from torch_threads import one_torch_thread  # noqa: F401

_CSRC = Path(optim.__file__).resolve().parent.parent / "csrc"
_SCALE = (_CSRC / "multi_tensor_scale.cu").read_text()
_SGD = (_CSRC / "sgd.cu").read_text()


def _constant(src, name):
    return int(re.search(rf"constexpr (?:int|long long) {name} = (\d+)",
                         src).group(1))


# ----------------------------------------------------------- the plans

@pytest.mark.parametrize("size", [0, 1, 2, 3, 7, 8, 9, 15, 16, 17, 64,
                                  70001])
@pytest.mark.parametrize("width,offsets", [
    (4, (0, 0)), (4, (4, 4, 4)), (4, (12, 12)), (4, (0, 4)),
    (4, (8, 8, 2)), (8, (0, 0)), (8, (2, 2)), (8, (6, 6, 6)), (8, (14, 14)),
    (8, (2, 4)), (8, (0, 0, 8))])
def test_plan_covers_every_element_once(size, width, offsets):
    """head, vectors * width and tail partition the tensor; vector
    accesses only where every list is aligned alike, starting on the
    16-byte boundary; the kernels' scalar index q (element q below the
    head, q + width * vectors past it) reaches the head and tail once."""
    span = optim.adam_plan(size, offsets, width)
    unit = 16 // width
    assert span.head + width * span.vectors + span.tail == size
    assert min(span) >= 0
    if len(set(offsets)) == 1 and offsets[0] % unit == 0:
        assert span.head < width and span.tail < width
        assert span.vectors == 0 or (offsets[0] + unit * span.head) % 16 == 0
        assert span.vectors == (size - span.head) // width
    else:
        assert span == (size, 0, 0)
    scalars = range(size - width * span.vectors)
    elems = [q if q < span.head else q + width * span.vectors
             for q in scalars]
    elems += range(span.head, span.head + width * span.vectors)
    assert sorted(elems) == list(range(size))


def test_adam_plan_keeps_its_four_element_cover():
    """The width argument leaves Adam's calls (fp32 offsets, 4 elements
    a vector) as they were."""
    for size in (0, 5, 65539):
        for off in (0, 4, 8, 12):
            assert (optim.adam_plan(size, (off,) * 4)
                    == optim.adam_plan(size, (off,) * 4, 4))


@pytest.mark.parametrize("dtypes,width", [
    ((torch.bfloat16, torch.bfloat16), 8),
    ((torch.bfloat16, torch.bfloat16, torch.bfloat16), 8),
    ((torch.float32, torch.float32), 4),
    ((torch.bfloat16, torch.float32), 4),
    ((torch.float32, torch.bfloat16), 4),
    ((torch.bfloat16, torch.bfloat16, torch.float32), 4)])
def test_vector_width(dtypes, width):
    """8 elements (16 bytes) where every list is bf16, else 4."""
    assert ks.vector_width(dtypes) == width


# --------------------------------------------------------------- heads

@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("seed", range(4))
def test_plan_heads_are_adam_plans_heads(width, seed):
    """The launches' heads, integer arithmetic on the pointers the tables
    hold, are :func:`adam_plan`'s on :func:`_phase`'s offsets: random
    pointers in two to four lists, fp32 and bf16 (bf16 only at width
    8), some tensors aligned alike in every list."""
    rng = np.random.RandomState(seed)
    lists = 2 + seed % 3
    items = tuple(2 if width == 8 or j % 2 else 4 for j in range(lists))
    ptrs = [[int(rng.randint(0, 1 << 20)) * i for _ in range(20)]
            for i in items]
    for k in range(0, 20, 4):
        e = int(rng.randint(0, width))
        for col, i in zip(ptrs, items):
            col[k] = 64 * int(rng.randint(1, 1000)) + e * i
    sizes = tuple(int(n) for n in rng.choice([0, 1, 3, 7, 8, 9, 1000], 20))
    got = list(optim._plan_heads(tuple(map(tuple, ptrs)), items, sizes,
                                 width))
    unit = 16 // width
    want = [optim.adam_plan(size, [a % (width * i) // i * unit
                                   for a, i in zip(addrs, items)],
                            width).head
            for size, addrs in zip(sizes, zip(*ptrs))]
    assert got == want
    assert any(h < size for h, size in zip(got, sizes))


def _heads(lists, keyed, width=4):
    """Each tensor's head as the launches hand them to the C functions
    (``_runs``' ``heads``), in the tensors' order."""
    heads = {}
    for _, index, _, _, of, _ in optim._runs(lists, keyed):
        heads.update(zip(index, of(width)))
    return [heads[k] for k in sorted(heads)]


def _flat(dtype, n=128):
    t = torch.zeros(n, dtype=dtype)
    assert t.data_ptr() % 16 == 0
    return t


@pytest.mark.parametrize("width,dtype,elems,want", [
    (4, torch.float32, (0, 1, 2, 3), (0, 3, 2, 1)),
    (4, torch.bfloat16, (0, 1, 2, 3, 5), (0, 3, 2, 1, 3)),
    (8, torch.bfloat16, (0, 1, 3, 4, 7, 9), (0, 7, 5, 4, 1, 7))])
def test_heads_from_views_in_place(width, dtype, elems, want):
    """In place (x is out): the head runs to the next boundary of the
    vector width, from views at odd element offsets into a flat buffer
    (2- to 14-byte offsets)."""
    flat = _flat(dtype)
    xs = [flat[e:e + 40] for e in elems]
    assert _heads(dict(x=xs, y=[None] * len(xs), out=xs),
                  ("x", "y", "out"), width) == list(want)


def test_heads_out_of_place_into_the_other_dtype():
    """fp32 x and bf16 out (and back) at the same element phase share
    4-element vectors; out one element off x leaves the tensor all
    head, as does a y off the others in axpby."""
    f, b = _flat(torch.float32), _flat(torch.bfloat16)
    xs = [f[e:e + 30] for e in (1, 2, 3)] + [f[1:31]]
    outs = [b[e:e + 30] for e in (5, 6, 7)] + [b[2:32]]
    assert ks.vector_width([x.dtype for x in (xs[0], outs[0])]) == 4
    keyed = ("x", "y", "out")
    assert _heads(dict(x=xs, y=[None] * 4, out=outs), keyed) == [3, 2, 1, 30]
    assert _heads(dict(x=outs, y=[None] * 4, out=xs), keyed) == [3, 2, 1, 30]
    ys = [f[e + 1:e + 31] for e in (1, 2, 3)] + [f[1:31]]
    assert _heads(dict(x=xs, y=ys, out=outs), keyed) == [30, 30, 30, 30]


def test_heads_of_sgd_lists():
    """SGD's g (bf16 or fp32), p and mom (fp32) and optional output."""
    f, f2, f3 = (_flat(torch.float32) for _ in range(3))
    b = _flat(torch.bfloat16)
    gs = [b[1:20], f3[2:9], b[0:3], b[3:20]]
    ps = [f[1:20], f[42:49], f[60:63], f[67:84]]
    moms = [f2[1:20], f2[42:49], f2[60:63], f2[67:84]]
    outs = [None, f3[22:29], None, b[35:52]]
    lists = dict(g=gs, p=ps, mom=moms, out=outs)
    assert _heads(lists, ("g", "out")) == [3, 2, 0, 1]
    moms[1] = f2[43:50]  # mom off the others: all head
    assert _heads(lists, ("g", "out")) == [3, 7, 0, 1]


# ---------------------------------------------------------------- walk

def _walk(sizes, heads, width, threads, unroll, grid):
    """A model of scale_vec_kernel's and sgd_vec_kernel's walk with small
    blocks: each tensor's chunks are the larger of its vectors over
    threads * unroll and its scalar elements over width times that; each
    block walks the chunks grid-stride, a thread taking its unroll
    vectors, then its scalar elements. Returns each element's visits."""
    chunk = threads * unroll
    first = [0]
    for size, head in zip(sizes, heads):
        vecs = (size - head) // width
        scal = size - width * vecs
        first.append(first[-1] + max(-(-vecs // chunk),
                                     -(-scal // (width * chunk))))
    hits = [[0] * size for size in sizes]
    for block in range(grid):
        k = 0
        for c in range(block, first[-1], grid):
            while first[k + 1] <= c:
                k += 1
            local, size, head = c - first[k], sizes[k], heads[k]
            vecs = (size - head) // width
            for t in range(threads):
                for u in range(unroll):
                    i = local * chunk + t + u * threads
                    if i < vecs:
                        for e in range(width):
                            hits[k][head + width * i + e] += 1
                end = min((local + 1) * width * chunk, size - width * vecs)
                for q in range(local * width * chunk + t, end, threads):
                    hits[k][q if q < head else q + width * vecs] += 1
    return hits


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("threads,unroll,grid", [(4, 2, 3), (2, 1, 1),
                                                 (8, 4, 5)])
def test_walk_visits_every_element_once(width, threads, unroll, grid):
    rng = np.random.RandomState(threads + grid + width)
    sizes = [int(n) for n in rng.choice([0, 1, 3, 7, 9, 33, 64, 130, 257],
                                        12)]
    offsets = [int(o) * (16 // width)
               for o in rng.choice(range(width), 12)]
    heads = [optim.adam_plan(n, (o, o) if k % 3 else (o, o + 16 // width),
                             width).head
             for k, (n, o) in enumerate(zip(sizes, offsets))]
    hits = _walk(sizes, heads, width, threads, unroll, grid)
    assert all(h == 1 for hs in hits for h in hs)


def test_walk_constants_match_the_sources():
    """The bodies' block size, vectors a thread loads and table size, as
    the model and the wrappers take them."""
    for src in (_SCALE, _SGD):
        assert _constant(src, "kThreads") == 256
        assert _constant(src, "kUnroll") == 4
        assert _constant(src, "kMaxTensors") == ks.MAX_TENSORS
    assert ks.MAX_TENSORS == optim.MAX_TENSORS


@pytest.mark.parametrize("src,pointer_lists", [(_SCALE, 3), (_SGD, 4)])
def test_launch_table_fits_the_parameter_limit(src, pointer_lists):
    """Pointers, sizes, prefix chunk counts, int heads and the count, with
    the other arguments, under the 4 KB a kernel's parameters may take."""
    n = _constant(src, "kMaxTensors")
    table = pointer_lists * 8 * n + 8 * n + 8 * (n + 1) + 4 * n + 4
    others = 64  # the scale/flag/noop/step pointers and the floats
    assert table + others < 4096, table


# ---------------------------------------------------- the path, on the CPU

@pytest.fixture
def recorded(monkeypatch):
    """The C functions replaced by recorders; CUDA contexts and streams
    by stand-ins, so the wrappers' launch code runs on CPU tensors."""
    calls = []

    def recorder(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(ks, "_kernel", lambda: recorder)
    monkeypatch.setattr(optim, "_sgd_kernel", lambda: recorder)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(_checks, "stream", lambda t: 0)
    return calls


def test_scale_launch_takes_the_streaming_body(recorded):
    """``launch`` (the wrappers' launch) takes path 1 with each tensor's
    head at the group's width: bf16 in place at 8, fp32 at 4; the first
    design gets no heads."""
    before = registry.launches()
    fb, ff = _flat(torch.bfloat16), _flat(torch.float32)
    xs = [fb[3:40], ff[1:30], fb[8:9], ff[0:0]]
    flag = torch.zeros(1)
    assert ks.launch(ks.SCALE, flag, xs, xs, xs, 0, 0.0, 0.0) == 2
    (bf16_call, fp32_call) = recorded
    for call, heads, sizes, code in ((bf16_call, [5, 0], [37, 1], 1),
                                     (fp32_call, [3, 0], [29, 0], 0)):
        assert list(call[4]) == heads and list(call[3]) == sizes
        assert call[6] == call[8] == code  # x and out dtype codes
        assert call[9] == ks.SCALE and call[-2] == ks.STREAM
    recorded.clear()
    ks.launch(ks.SCALE, flag, xs, xs, xs, 0, 0.0, 0.0, path=ks.FIRST)
    assert all(call[4] is None and call[-2] == ks.FIRST for call in recorded)
    assert registry.launches() == before  # launch counts nothing


def test_axpby_launch_heads_cover_y(recorded):
    fb = _flat(torch.bfloat16)
    xs, ys, outs = [fb[1:20]], [fb[33:52]], [fb[65:84]]
    ks.launch(ks.AXPBY, torch.zeros(1), xs, ys, outs, None, 0.5, 2.0)
    (call,) = recorded
    assert list(call[4]) == [7] and call[-2] == ks.STREAM
    recorded.clear()
    ks.launch(ks.AXPBY, torch.zeros(1), xs, [fb[34:53]], outs, None, 0.5,
              2.0)
    assert list(recorded[0][4]) == [19]  # y one element off: all head


def test_sgd_launch_takes_the_streaming_body(recorded):
    f, f2 = _flat(torch.float32), _flat(torch.float32)
    b = _flat(torch.bfloat16)
    gs, ps, moms = [b[2:30]], [f[2:30]], [f2[2:30]]
    step = torch.zeros(1, dtype=torch.int32)
    kw = dict(step=step, inv_scale=None, wd=0.0, momentum=0.9,
              dampening=0.0, lr=0.1, nesterov=False, wd_after_momentum=False)
    assert optim.launch_sgd(torch.zeros(1), gs, ps, moms, None, **kw) == 1
    (call,) = recorded
    assert list(call[5]) == [2] and list(call[4]) == [28]
    assert call[-2] == optim.SGD_STREAM and call[-3] == 0  # path, fault
    recorded.clear()
    optim.launch_sgd(torch.zeros(1), gs, ps, moms, None, **kw,
                     path=optim.SGD_FIRST)
    assert recorded[0][-2] == optim.SGD_FIRST


def _c_params(src, symbol):
    """The parameter names of C function ``symbol``, in order."""
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src).group(1)
    return [p.split()[-1].lstrip("*") for p in params.split(",")]


def test_path_codes_match_the_sources(recorded):
    """apex_multi_tensor_scale's and apex_sgd's paths 0 and 1, the
    wrappers' default the streaming body: the launches hand the path,
    the fault and the heads in the C functions' own places."""
    assert (ks.FIRST, ks.STREAM) == (0, 1)
    assert (optim.SGD_FIRST, optim.SGD_STREAM) == (0, 1)
    f, f2, b = _flat(torch.float32), _flat(torch.float32), _flat(
        torch.bfloat16)
    ks.launch(ks.SCALE, torch.zeros(1), [b[8:40]], [b[8:40]], [b[8:40]], 0,
              0.0, 0.0, 2)
    optim.launch_sgd(torch.zeros(1), [f[4:30]], [f2[4:30]], [f[40:66]], None,
                     step=torch.zeros(1, dtype=torch.int32), inv_scale=None,
                     wd=0.0, momentum=0.9, dampening=0.0, lr=0.1,
                     nesterov=False, wd_after_momentum=False, fault=1)
    for call, src, symbol, fault in (
            (recorded[0], _SCALE, "apex_multi_tensor_scale", 2),
            (recorded[1], _SGD, "apex_sgd", 1)):
        named = dict(zip(_c_params(src, symbol), call))
        assert len(named) == len(call)
        assert named["path"] == 1 and named["fault"] == fault
        assert list(named["heads"]) == [0]
