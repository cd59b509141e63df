"""The port's probes (dedflow_tpu_torch.tools: K12 gmicro, K13 gather_probe)
against the JAX tools' Pallas kernels in interpret mode.

K12: the JAX tool builds its eleven kernels as closures inside
`tools/gmicro.py::main`, so the test loads the tool by path, records what
`main` hands its timer (`_run`) at n = 2048 and runs each kernel through
its own `pl.pallas_call(..., interpret=True)` with the tool's (8, 512)
block specs. Each runs on the tool's indices and on indices over the full
range of its function (the window gathers' zero branch, every bin row of
the segment reduce), with two inputs: bf16-representable values (every
body, one-hot ones included, is exact: the bf16 hi/lo split keeps them
whole and their sums are exact in float32) and raw float32 values (exact
for the copy and the lane and window gathers; within 3e-5 of the largest
value for the one-hot bodies, whose hi/lo split keeps ~16 of 24 mantissa
bits). The segment reduce's bins are held against a numpy definition,
and the library calls chip_smoke.py times against the plain versions.

K13: `tools/gather_probe.py`'s one-hot kernel (both precisions) and its
take_along_axis kernel, at W = 512, E = 256 and 2 blocks in interpret
mode, against the port's element gather: exact.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dedflow_tpu_torch.tools import gather_probe as tgp
from dedflow_tpu_torch.tools import gmicro as tgm
from dedflow_tpu_torch.tools.timing import sector_bytes

ROOT = Path(__file__).resolve().parents[1]
N = 2048  # lanes a row: 4 blocks of 512
ONE_HOT = ("OH-matmul gather 512-win x4",) + tuple(f"OH seg-reduce quad HB={hb}" for hb in tgm.HBS)
TOL_ONE_HOT = 3e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU's cores among its
    workers, and torch's own thread pool would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _load_tool(name: str):
    """tools/<name>.py as a module (it is a script, not a package module);
    sys.path as it was before (gmicro.py puts "." in front)."""
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def tool_kernels():
    """{variant name: (jitted interpret-mode pallas_call, the tool's extra
    inputs)} from tools/gmicro.py::main at n = N. The persistent compile
    cache `main` would switch on is kept out of the worker."""
    recorded = {}

    def record(name, kernel, n, nops_per_block, extra_in=None, reps=8):
        assert n == N
        block = pl.BlockSpec((8, 512), lambda i: (0, i))
        call = pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((8, n), jnp.float32), grid=(n // 512,),
            in_specs=[block] * (1 + len(extra_in or [])), out_specs=block, interpret=True,
        )
        recorded[name] = (jax.jit(call), list(extra_in or []))

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(ROOT)  # the tool imports bench.py from "."
        gm = _load_tool("gmicro")
        mp.setattr(gm, "_run", record)
        mp.setattr(jax.config, "update", lambda *a, **k: None)
        mp.setattr(sys, "argv", ["gmicro", str(N)])
        gm.main()
    return recorded


def _full_range_idx(name: str, rng) -> np.ndarray:
    """Indices over the full range of the variant's function: the lane
    gathers' [0, 128) (k_taa8 takes them unmasked), the window gathers'
    [0, 512 (nwin + 1)) so that the zero branch runs, the one-hot gather's
    [0, 4096) (it masks to 511), and [0, 2048) for the segment reduce, which
    hits every bin row h of every hb and runs its mask for hb < 16."""
    hi = 128
    if name.startswith("win_body"):
        hi = 512 * (int(name.rsplit("=", 1)[1]) + 1)
    elif name.startswith("OH-matmul"):
        hi = 4096
    elif name.startswith("OH seg-reduce"):
        hi = 2048
    return rng.integers(0, hi, size=(8, N)).astype(np.int32)


def _inputs(rng):
    """(bf16-representable x, raw float32 x): multiples of 1/8 in [-8, 8]
    (whose sums of up to 4096 terms are exact in float32), and standard
    normal values."""
    x_bf16 = (rng.integers(-64, 65, size=(8, N)) / 8.0).astype(np.float32)
    return x_bf16, rng.standard_normal((8, N)).astype(np.float32)


VARIANTS = [
    "copy*2", "take_along (8,128) x4", "take_along (32,128) x1", "win_body emul nwin=1",
    "win_body emul nwin=2", "win_body emul nwin=4", "OH-matmul gather 512-win x4",
] + [f"OH seg-reduce quad HB={hb}" for hb in tgm.HBS]


def test_the_port_probes_the_tools_variants_in_order(tool_kernels):
    x, idx = tgm.inputs(N, torch.device("cpu"))
    assert [p.name for p in tgm.probes(x, idx)] == list(tool_kernels) == VARIANTS


@pytest.mark.parametrize("indices", ["tool", "full"])
@pytest.mark.parametrize("name", VARIANTS)
def test_k12_plain_twins_match_the_jax_kernels(tool_kernels, name, indices):
    call, extra = tool_kernels[name]
    rng = np.random.default_rng(VARIANTS.index(name))
    idx = np.array(extra[0]) if extra else rng.integers(0, 128, (8, N)).astype(np.int32)
    if indices == "full":
        idx = _full_range_idx(name, rng)
        assert not extra or idx.max() >= 128 or name.startswith("take_along")
    for kind, x in zip(("bf16", "f32"), _inputs(rng)):
        want = np.asarray(call(*[jnp.asarray(x)] + ([jnp.asarray(idx)] if extra else [])))
        (probe,) = [p for p in tgm.probes(torch.from_numpy(x), torch.from_numpy(idx))
                    if p.name == name]
        got = probe.kernel().numpy()  # a CPU tensor: the wrapper runs the plain version
        if kind == "f32" and name in ONE_HOT:
            err = np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()
            assert err <= TOL_ONE_HOT, (kind, err)
        else:
            np.testing.assert_array_equal(got, want, err_msg=kind)


def _bins_numpy(x, idx):
    """o[r, 512b + 128q + l] = sum of x[r', 512b + j] over the rows r' and
    the j with (idx[0, 512b + j] & 127) = l."""
    nblk = x.shape[1] // 512
    bins = np.zeros((nblk, 128))
    for b in range(nblk):
        for j in range(512):
            bins[b, int(idx[0, 512 * b + j]) & 127] += x[:, 512 * b + j].sum()
    return np.broadcast_to(np.repeat(bins[:, None, :], 4, axis=1).reshape(1, -1), x.shape)


@pytest.mark.parametrize("hb", tgm.HBS)
def test_k12_segment_reduce_equals_numpy_bins(hb):
    rng = np.random.default_rng(hb)
    x, _ = _inputs(rng)
    idx = rng.integers(0, 2048, (8, N)).astype(np.int32)
    o = tgm.segment_reduce(torch.from_numpy(x), torch.from_numpy(idx), hb)
    np.testing.assert_array_equal(o.numpy(), _bins_numpy(x, idx))  # exact: multiples of 1/8


@pytest.fixture(scope="module")
def jax_gmicro():
    """tools/gmicro.py as a module (its `k_reduce` takes hb as an argument)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(ROOT)  # the tool imports bench.py from "."
        return _load_tool("gmicro")


@pytest.mark.parametrize("hb", (1, 2, 4, 8, 16))
def test_k12_segment_reduce_o_equals_jax_k_reduce_at_every_hb(jax_gmicro, hb):
    """The reduce's o (rows, then bins) against the JAX kernel k_reduce(hb)
    in interpret mode, hb 2 included (the tool sweeps 16 / 8 / 4 / 1), on
    ids over [0, 2048): exact on bf16-representable values, within the
    one-hot bodies' 3e-5 on raw float32."""
    block = pl.BlockSpec((8, 512), lambda i: (0, i))
    call = jax.jit(pl.pallas_call(
        functools.partial(jax_gmicro.k_reduce, hb=hb),
        out_shape=jax.ShapeDtypeStruct((8, N), jnp.float32), grid=(N // 512,),
        in_specs=[block, block], out_specs=block, interpret=True))
    rng = np.random.default_rng(100 + hb)
    idx = rng.integers(0, 2048, (8, N)).astype(np.int32)
    for kind, x in zip(("bf16", "f32"), _inputs(rng)):
        want = np.asarray(call(jnp.asarray(x), jnp.asarray(idx)))
        got = tgm.segment_reduce(torch.from_numpy(x), torch.from_numpy(idx), hb).numpy()
        if kind == "bf16":
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got.astype(np.float64) - want).max() / np.abs(want).max() <= TOL_ONE_HOT


def test_k12_segment_reduce_o_is_the_same_for_every_hb():
    """The collapsed bins do not depend on hb: o is equal bit for bit for
    hb 1-16 on raw float32 inputs and full-range ids, and agrees with the
    numpy bins in float64 within 1e-5."""
    rng = np.random.default_rng(17)
    _, x = _inputs(rng)
    x, idx = torch.from_numpy(x), torch.from_numpy(rng.integers(0, 2048, (8, N)).astype(np.int32))
    outs = [tgm.segment_reduce(x, idx, hb) for hb in (1, 2, 4, 8, 16)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    want = _bins_numpy(x.numpy().astype(np.float64), idx.numpy())
    assert np.abs(outs[0].numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("name", VARIANTS)
def test_k12_library_calls_match_the_plain_versions(name):
    x, idx = tgm.inputs(N, torch.device("cpu"), seed=3)
    (probe,) = [p for p in tgm.probes(x, idx) if p.name == name]
    call, ref = probe.library
    want = ref()
    got = call().reshape(want.shape)  # the lane gathers' (8, n / 128, 128) view
    if probe.exact:
        assert torch.equal(got, want)
    else:  # scatter_add against index_add: float32 sums of at most 512 terms
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_k12_window_gather_library_call_is_the_one_hot_row():
    """The window gathers' library call (a torch.gather of 512b + (id &
    511)) is the one-hot row's function for any ids, and the nwin rows'
    only where every id is a hit."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((8, N)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 4096, (8, N)).astype(np.int32))
    probe = [p for p in tgm.probes(x, idx) if p.name.startswith("OH-matmul")][0]
    assert torch.equal(probe.library[0](), tgm.window_gather_plain(x, idx, 1, wrap=True))
    assert not torch.equal(probe.library[0](), tgm.window_gather_plain(x, idx, 1))


def test_sector_bytes_counts_each_touched_sector_once():
    # float32 elements 0 and 7 share sector 0; 8 (twice) is sector 1; 100 is sector 12
    assert sector_bytes(torch.tensor([0, 7, 8, 8, 100])) == 3 * 32
    assert sector_bytes(torch.tensor([3, 4], dtype=torch.int32), elem_size=16) == 2 * 32
    assert sector_bytes(torch.zeros(0, dtype=torch.long)) == 0


def _window_sectors(idx, nwin, wrap):
    """Distinct 32-byte sectors of one row of x that the window gather of
    idx's row 0 reads, by its definition, block by block."""
    total = 0
    for b in range(idx.shape[1] // 512):
        ids = idx[0, 512 * b: 512 * (b + 1)].astype(np.int64)
        if wrap:
            ids = ids & 511
        hit = ((ids >> 9) >= 0) & ((ids >> 9) < nwin)
        total += len(set(((ids[hit] & 511) >> 3).tolist()))
    return total


@pytest.mark.parametrize("indices", ["tool", "full"])
def test_k12_bytes_count_what_the_ids_read(indices):
    """The gathers' bytes count the sectors of x their ids select: with
    the tool's ids (< 128) the window gathers read tile 0 of each block, a
    quarter of x; the copy and the reduce read all of x."""
    rng = np.random.default_rng(5)
    x, idx = tgm.inputs(N, torch.device("cpu"))
    if indices == "full":
        idx = torch.from_numpy(rng.integers(-600, 512 * 5, (8, N)).astype(np.int32))
    probes = {p.name: p for p in tgm.probes(x, idx)}
    stream, row = 4 * 8 * N, 4 * N
    assert probes["copy*2"].nbytes == 2 * stream
    for hb in tgm.HBS:
        assert probes[f"OH seg-reduce quad HB={hb}"].nbytes == 2 * stream + row
    wins = [(f"win_body emul nwin={nw}", nw, False) for nw in tgm.NWINS]
    for name, nwin, wrap in wins + [("OH-matmul gather 512-win x4", 1, True)]:
        sectors = _window_sectors(idx.numpy(), nwin, wrap)
        if indices == "tool":
            assert sectors == 16 * (N // 512)  # tile 0: 128 lanes, 16 sectors
        assert probes[name].nbytes == 8 * 32 * sectors + stream + row, name
    lane = idx.numpy().astype(np.int64) & 127
    tiles = lane.reshape(8, N // 128, 128) >> 3
    lane_sectors = sum(len(set(t.tolist())) for t in tiles.reshape(-1, 128))
    assert probes["take_along (32,128) x1"].nbytes == 32 * lane_sectors + 2 * stream


def test_k13_bytes_count_the_window_rows_the_ids_read():
    idx = torch.tensor([[0, 5, -1, 9], [2, 5, 1, 0], [9, 3, 3, 12], [1, 1, 1, 1]],
                       dtype=torch.int32)
    win = torch.zeros((10, 16))
    (probe, _) = tgp.probes(idx, win)
    rows = 6  # nodes 0, 1, 2, 3, 5, 9; -1 and 12 lie outside the window
    assert probe.nbytes == 64 * rows + idx.numel() * 4 + 64 * 4 * 4


@pytest.mark.parametrize("tool", ["gmicro", "gather_probe"])
def test_probe_runs_on_the_cpu_return_their_records(capsys, tool):
    """The entry points' runs return one record a line: host-clock times,
    no paced time, no launches (the plain versions ran), and
    max|err| 0."""
    mod, size = {"gmicro": (tgm, 1024), "gather_probe": (tgp, 512)}[tool]
    recs = mod.run(size, torch.device("cpu"))
    names = VARIANTS if mod is tgm else ["global", "staged"]
    assert [r["name"] for r in recs] == names
    for r in recs:
        assert r["launches"] == 0 and r["paced_ms"] is None and r["max_abs_err"] == 0.0
        assert min(r["ms"], r["plain_ms"], r["library_ms"]) > 0 and r["bound_by"] == "bytes"
    assert len([ln for ln in capsys.readouterr().out.splitlines() if "max|err|" in ln]) == len(names)


@pytest.fixture(scope="module")
def gather_tool():
    gp = _load_tool("gather_probe")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gp, "INTERPRET", True)
        mp.setattr(gp, "W", 512)
        mp.setattr(gp, "E", 256)
        yield gp


def _tala_idx(idx, nb, gp):
    """tools/gather_probe.py:136-143: block b's idx[a] in the first E lanes
    of rows b * 4C + a * C + c of an (nb * 4C, W) array."""
    blk = idx.reshape(4, nb, gp.E).transpose(1, 0, 2)
    out = np.zeros((nb, 4, gp.C, gp.W), np.int32)
    out[..., : gp.E] = blk[:, :, None, :]
    return out.reshape(nb * 4 * gp.C, gp.W)


@pytest.mark.parametrize("kernel", ["onehot-default", "onehot-highest", "tala"])
def test_k13_plain_twin_matches_the_jax_kernels(gather_tool, kernel):
    gp, nb = gather_tool, 2
    rng = np.random.default_rng(13)
    idx = rng.integers(0, gp.W, (4, nb * gp.E)).astype(np.int32)
    win = rng.standard_normal((gp.W, gp.C)).astype(np.float32)
    if kernel == "tala":
        want = gp.run_tala(nb, jnp.asarray(_tala_idx(idx, nb, gp)), jnp.asarray(win.T))
    else:
        precision = jax.lax.Precision.HIGHEST if kernel.endswith("highest") else None
        want = gp.run_onehot(nb, precision, jnp.asarray(idx), jnp.asarray(win))
    want = np.asarray(want)
    assert want.shape == (4 * gp.C, nb * gp.E)
    np.testing.assert_array_equal(win[idx].transpose(0, 2, 1).reshape(want.shape), want)
    for idiom in ("global", "staged"):
        got = tgp.element_gather(torch.from_numpy(idx), torch.from_numpy(win), idiom)
        np.testing.assert_array_equal(got.numpy(), want)


def test_k13_ids_outside_the_window_gather_zeros():
    idx = torch.tensor([[0, 5, -1], [2, 7, 1], [8, 3, 3], [1, 1, 1]], dtype=torch.int32)
    win = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    out = tgp.element_gather_plain(idx, win).reshape(4, 16, 3)
    assert torch.equal(out[0, :, 2], torch.zeros(16)) and torch.equal(out[2, :, 0], torch.zeros(16))
    assert torch.equal(out[1, :, 1], win[7])


def test_k13_library_call_matches_the_plain_version():
    idx, win = tgp.inputs(512, torch.device("cpu"), nb=2)
    for probe in tgp.probes(idx, win):
        call, ref = probe.library
        assert torch.equal(call(), ref())


def test_k13_staged_passes():
    assert [tgp.staged_passes(w) for w in (512, 3632, 3633, 4096, 7264, 14528)] == [1, 1, 2, 2, 2, 4]
    with pytest.raises(ValueError, match="at most 14528 nodes"):
        tgp.staged_passes(14529)


@pytest.mark.parametrize(
    "tool,argv", [(tgm, ["1024", "--device", "cpu"]), (tgp, ["512", "--device", "cpu"])],
    ids=["gmicro", "gather_probe"],
)
def test_probe_entry_points_on_the_cpu(capsys, tool, argv):
    """`--device cpu` runs the plain versions and says so; every line
    checks against the plain version (max|err| 0)."""
    assert tool.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    rows = [ln for ln in lines if "max|err|" in ln]
    assert len(rows) == (11 if tool is tgm else 2)
    assert all("max|err| 0.0e+00" in ln for ln in rows)


@pytest.mark.parametrize("tool", ["gmicro", "gather_probe"])
def test_probe_entry_points_default_to_the_card(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back"):
        {"gmicro": tgm, "gather_probe": tgp}[tool].main([])
