"""The port's twins of the reference's serving examples
(``examples/quickstart_torch.py``, ``examples/serve_retrieval_torch.py``)
run at smoke size on the CPU beside the reference's, and print the same
report: line for line the same text once the numbers are masked, and the
same numbers where the configuration fixes them (the model, the items
embedded, the store's bytes and items, the layers a fixed policy runs,
the queries and refinements). Accuracies, times, the exits the predictor
picks and the ids retrieved depend on each package's random draws and
are not compared. The four runs go in parallel."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
NUM = re.compile(r"-?\d+(?:\.\d+)?")
MASK = re.compile(r" *-?\d+(?:\.\d+)?")  # a number and its padding


@pytest.fixture(scope="module")
def outputs():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}
    runs = {
        "quickstart": (["quickstart.py"], ["quickstart_torch.py",
                                           "--device", "cpu"]),
        "serve_retrieval": (
            ["serve_retrieval.py", "--n-items", "48", "--n-queries", "8"],
            ["serve_retrieval_torch.py", "--n-items", "48", "--n-queries",
             "8", "--device", "cpu"]),
    }
    procs = {(name, side): subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / args[0])] + args[1:],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for name, pair in runs.items() for side, args in zip(("ref", "port"),
                                                             pair)}
    out = {}
    for key, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, (key, stderr[-2000:])
        out[key] = [line for line in stdout.splitlines() if line.strip()]
    return out


def _masked(lines):
    return [MASK.sub("#", line) for line in lines]


def test_quickstart_torch_prints_the_reference_report(outputs):
    ref, port = outputs["quickstart", "ref"], outputs["quickstart", "port"]
    assert _masked(port) == _masked(ref)
    assert port[0] == ref[0]  # the model and its exits
    nums = [NUM.findall(line) for line in (ref, port)[0]]
    got = [NUM.findall(line) for line in port]
    assert got[1][1] == nums[1][1]  # the predictor's params
    assert got[2][0] == nums[2][0] == "128"  # items embedded
    assert got[2][-1] == nums[2][-1]  # the store's bytes
    refined = [re.findall(r"refined (\d+)", out[3]) for out in (ref, port)]
    assert refined[0] == refined[1]  # candidates refined by the first query


def test_serve_retrieval_torch_prints_the_reference_report(outputs):
    ref = outputs["serve_retrieval", "ref"]
    port = outputs["serve_retrieval", "port"]
    assert _masked(port) == _masked(ref)
    assert port[0] == ref[0]
    for r, p in zip(ref[1:5], port[1:5]):
        rn, pn = r.split(), p.split()
        assert pn[0] == rn[0] and pn[-1] == rn[-1]  # policy, store items
        if pn[0] != "recall":  # the predictor picks recall's exits
            assert pn[2:4] == rn[2:4]  # avg layers, groups
    assert NUM.findall(port[5])[:1] == NUM.findall(ref[5])[:1]  # queries
    assert port[5].split("), ")[1].split()[0] == \
        ref[5].split("), ")[1].split()[0]  # refinements
