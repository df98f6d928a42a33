"""giddy_tpu_torch.cli against giddy_tpu.cli on the CPU: every subcommand
runs in-process through ``main(argv)`` in both packages (the port's with
``--device cpu``) on the same numpy-seeded inputs, and the files each
writes and the lines each prints must be equal: gen, encode (a scheme,
``auto``, ``--valid``), pack, import/export (CSV, and a partitioned
dataset), decode (``--ref`` too), validate, info (container and dataset),
query (``--between``, ``--select``), groupby (``--where``) and agg. The
reference's commands run as one batch a test in the worker's reference
process (test_torch_inputs.JAX), so that the worker itself keeps none of
their interpret-mode programs. ``bench`` runs bench_torch.py's main with
the options it was given (bench_torch.py against bench.py:
test_torch_bench.py)."""

import contextlib
import io
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from giddy_tpu_torch import cli
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import JAX, PRIORITIES, rng_of

N = 2 * GROUP + 999
# Subcommands that take --device in the port.
ON_DEVICE = {"encode", "import", "export", "decode", "validate", "query", "groupby", "agg"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run_cli(main, directory: str, argvs: list) -> list[tuple[str, object]]:
    """main(argv) for each argv, in ``directory``: (standard output, exit
    code); an exit message's program name is normalized."""
    here = os.getcwd()
    os.chdir(directory)
    out = []
    try:
        for argv in argvs:
            buf, code = io.StringIO(), 0
            with contextlib.redirect_stdout(buf):
                try:
                    main(argv)
                except SystemExit as e:
                    code = e.code.replace("giddy-tpu-torch", "giddy-tpu") if isinstance(e.code, str) else e.code
            out.append((buf.getvalue(), code))
    finally:
        os.chdir(here)
    return out


def reference_cli(directory: str, argvs: list) -> list:
    """giddy_tpu.cli.main over ``argvs`` (run in the reference process)."""
    from giddy_tpu import cli as jcli

    return run_cli(jcli.main, directory, argvs)


def both(root, argvs: list) -> list[tuple[str, str]]:
    """The reference's and the port's runs of ``argvs`` in root/ref and
    root/port: exit codes equal; returns their outputs, pairwise."""
    want = JAX(reference_cli, str(root / "ref"), argvs)
    got = run_cli(cli.main, str(root / "port"),
                  [a + ["--device", "cpu"] if a[0] in ON_DEVICE else a for a in argvs])
    assert [c for _, c in got] == [c for _, c in want], (got, want)
    return [(w, g) for (w, _), (g, _) in zip(want, got)]


@pytest.fixture
def root(tmp_path):
    for d in ("ref", "port"):
        (tmp_path / d).mkdir()
    return tmp_path


def same_file(root, name: str) -> None:
    assert (root / "ref" / name).read_bytes() == (root / "port" / name).read_bytes(), name


def put(root, name: str, arr: np.ndarray) -> None:
    for d in ("ref", "port"):
        np.save(root / d / name, arr)


def test_gen_encode_pack_info_decode_validate(root):
    put(root, "valid.npy", rng_of("cli/valid").random(N) > 0.1)
    put(root, "s.npy", np.array([PRIORITIES[i] for i in rng_of("cli/s").integers(0, 5, N)]))
    argvs = [["gen", s, "--n", str(N), "--seed", "3", "--out", f"{s}.npy"] for s in ("nbit", "delta", "rle", "dict")]
    argvs += [["encode", "nbit.npy", "nbit", "--out", "nbit.gtp"], ["encode", "rle.npy", "auto", "--out", "auto.gtp"],
              ["encode", "delta.npy", "delta", "--out", "delta.gtp", "--name", "ts"]]
    argvs += [["encode", "dict.npy", s, "--valid", "valid.npy", "--out", f"v{s}.gtp"] for s in ("dict", "auto")]
    argvs += [["pack", "a=auto:nbit.npy", "b=dict:dict.npy", "c=strdict:s.npy", "d=delta:delta.npy", "--out", "t.gtp"],
              ["info", "t.gtp"]]
    argvs += [["decode", "t.gtp", "--column", c, "--out", f"d{c}{r}.npy", *(["--ref"] if r else [])]
              for c in "0123" for r in ("", "ref")]
    argvs += [["validate", "t.gtp"]]
    outs = both(root, argvs)
    for want, got in outs:
        assert got == want
    assert outs[10][0].count("\n") == 4 and outs[-1][0].count("BIT-EXACT") == 4
    for name in ["nbit.npy", "delta.npy", "rle.npy", "dict.npy", "nbit.gtp", "auto.gtp", "delta.gtp", "vdict.gtp",
                 "vauto.gtp", "t.gtp"] + [f"d{c}{r}.npy" for c in "013" for r in ("", "ref")]:
        same_file(root, name)
    for r in ("", "ref"):  # the strings: object arrays pickle alike only in value
        a, b = (np.load(root / d / f"d2{r}.npy", allow_pickle=True) for d in ("ref", "port"))
        assert list(a) == list(b)


def test_decode_trace_writes_a_profile(tmp_path):
    run_cli(cli.main, str(tmp_path), [["gen", "for", "--n", str(N), "--out", "f.npy"],
                                      ["encode", "f.npy", "for", "--out", "f.gtp", "--device", "cpu"],
                                      ["decode", "f.gtp", "--trace", "trace", "--device", "cpu", "--out", "d.npy"]])
    assert any(name.endswith(".json") for name in os.listdir(tmp_path / "trace"))
    np.testing.assert_array_equal(np.load(tmp_path / "d.npy"), np.load(tmp_path / "f.npy"))


def test_query_groupby_agg(root):
    rng = rng_of("cli/query")
    put(root, "k.npy", rng.integers(0, 12, N).astype(np.int32) * 5)
    put(root, "x.npy", rng.integers(-500, 500, N).astype(np.int32))
    put(root, "p.npy", np.round(rng.uniform(0, 100, N), 2).astype(np.float32))
    argvs = [["pack", "k=dict:k.npy", "x=for:x.npy", "p=alp:p.npy", "--out", "q.gtp"]]
    argvs += [["query", "q.gtp", *a] for a in (
        ["--column", "1", "--op", "lt", "--value", "-20"], ["--column", "1", "--between", "-5", "5"],
        ["--column", "2", "--op", "ge", "--value", "99.5", "--select", "sel.npy"],
        ["--column", "0", "--op", "eq", "--value", "35"])]
    argvs += [["groupby", "q.gtp", *a] for a in (
        ["--keys", "0", "--vals", "1", "--aggs", "count,sum,min,max"],
        ["--keys", "0", "--vals", "2", "--aggs", "count,sum", "--where", "1", "--op", "ge", "--value", "0"],
        ["--keys", "0"])]
    argvs += [["agg", "q.gtp", agg, "--column", c] for c in "012"
              for agg in ("sum", "min", "max", "avg", "count", "distinct")]
    argvs += [["query", "q.gtp", "--column", "1"]]  # no --value: both exit with a message
    outs = both(root, argvs)
    for argv, (want, got) in zip(argvs, outs):
        assert got == want, argv
    assert all(want.count("\n") == 12 for want, _ in outs[5:8]) and outs[-1] == ("", "")
    same_file(root, "sel.npy")


def test_import_export_and_dataset_info(root):
    rng = rng_of("cli/csv")
    n = GROUP + 77
    df = pd.DataFrame({"id": np.arange(n), "v": rng.normal(0, 1, n), "c": [PRIORITIES[i] for i in rng.integers(0, 5, n)]})
    df.loc[rng.integers(0, n, 9), "v"] = np.nan
    for d in ("ref", "port"):
        df.to_csv(root / d / "in.csv", index=False)
    argvs = [["import", "in.csv", "--out", "in.gtp", "--scheme", "id=delta"], ["export", "in.gtp", "--out", "out.csv"],
             ["import", "in.csv", "--out", "ds", "--partitioned", "--rows-per-partition", str(GROUP // 2)],
             ["info", "ds"]]
    outs = both(root, argvs)
    for want, got in outs:
        assert got == want
    assert '"partitions": 3' in outs[-1][0]
    same_file(root, "in.gtp")
    same_file(root, "out.csv")
    for name in sorted(os.listdir(root / "ref" / "ds")):
        same_file(root, f"ds/{name}")


def test_bench_prints_the_bench_line(tmp_path, monkeypatch, capsys):
    """The subcommand's options reach bench_torch.main, which prints its
    line; each trial runs in this process here (test_torch_bench.py spawns
    them) and the selftest is stubbed (test_torch_selftest.py runs it)."""
    import bench_torch

    spawned = []

    def spawn_one(kind, args):
        spawned.append((kind, args.n, args.iters, args.trials, args.device))
        return bench_torch._run_one(kind, 1 << args.n, args.iters, args.device)

    monkeypatch.setattr(bench_torch, "RESULTS", tmp_path)
    monkeypatch.setattr(bench_torch, "_spawn_one", spawn_one)
    monkeypatch.setattr(bench_torch, "_run_selftest", lambda outdir, device: str(device) == "cpu")
    cli.main(["bench", "--n", "12", "--iters", "1", "--schemes", "nbit,rle", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["metric"] == "decode_GBps_geomean_headline5" and line["selftest_pass"] is True
    assert spawned == [(kind, 12, 1, 2, "cpu") for kind in ("nbit", "rle", "narrow")]
    assert list(json.loads((tmp_path / "bench_detail.json").read_text())["schemes"]) == ["nbit", "rle"]


def test_bench_needs_the_checkout(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "__file__", str(tmp_path / "giddy_tpu_torch" / "cli.py"))
    with pytest.raises(SystemExit, match="needs the repository checkout"):
        cli.main(["bench", "--device", "cpu"])


def test_missing_card_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the missing-card error cannot occur")
    np.save(tmp_path / "a.npy", np.arange(10, dtype=np.int32))
    cli.main(["encode", str(tmp_path / "a.npy"), "nbit", "--out", str(tmp_path / "a.gtp")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["decode", str(tmp_path / "a.gtp"), "--out", str(tmp_path / "b.npy")])
