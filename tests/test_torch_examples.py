"""The port's examples against the reference's on the CPU: the same
standard output, line for line.

examples/compression_tour_torch.py at log2_n = 14 and
examples/tpch_demo_torch.py at n = 2^16, both on ``device="cpu"``, print
exactly what examples/compression_tour.py and examples/tpch_demo.py print
at the same sizes (the tour's ratios and advisor picks, the demo's
answers, each example's own asserts passing on both sides). The reference
examples run in the worker's reference process (test_torch_inputs.JAX),
once per run (once_per_run). The port's examples are read as text and
parsed with ``ast`` to hold them to the port's rules: no JAX, nothing of
giddy_tpu, and the card by default."""

import ast
import contextlib
import io
import pathlib

import pytest
import torch

from examples_path import load_example
from test_torch_inputs import JAX, once_per_run

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
# reference example -> the size both packages run it at
SIZES = {"compression_tour": 14, "tpch_demo": 1 << 16}


def stdout_lines(name: str, *args, **kwargs) -> list[str]:
    """The lines that example ``name``'s main(*args, **kwargs) prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        load_example(name).main(*args, **kwargs)
    return out.getvalue().splitlines()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", list(SIZES))
def test_port_example_prints_the_reference_lines(tmp_path_factory, name):
    _, want = once_per_run(tmp_path_factory, f"example-{name}", lambda root: JAX(stdout_lines, name, SIZES[name]))
    got = stdout_lines(f"{name}_torch", SIZES[name], device="cpu")
    assert got == want
    assert got[-1] in ("all schemes decoded bit-exact vs the oracle", "ALL DEMO CHECKS PASSED")


def imported_modules(source: str) -> set[str]:
    """The top-level package of every module that ``source`` imports."""
    out = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("name", list(SIZES))
def test_port_example_names_no_jax(name):
    source = (EXAMPLES / f"{name}_torch.py").read_text()
    assert "jax" not in source and "giddy_tpu." not in source
    assert imported_modules(source) & {"jax", "jaxlib", "giddy_tpu"} == set()
    assert "giddy_tpu_torch" in imported_modules(source)


@pytest.mark.parametrize("name", list(SIZES))
def test_port_example_defaults_to_the_card(name):
    """main's ``device`` defaults to "cuda": here, with no card, the example
    raises at its first device call rather than falling back to the CPU."""
    main = next(node for node in ast.parse((EXAMPLES / f"{name}_torch.py").read_text()).body
                if isinstance(node, ast.FunctionDef) and node.name == "main")
    defaults = dict(zip([a.arg for a in main.args.args][::-1], main.args.defaults[::-1]))
    assert ast.literal_eval(defaults["device"]) == "cuda"
    small = {"compression_tour": 10, "tpch_demo": 1 << 12}[name]
    if torch.cuda.is_available():
        stdout_lines(f"{name}_torch", small)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stdout_lines(f"{name}_torch", small)
