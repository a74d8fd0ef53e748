"""The check decides: a whole run of each cell at its small size on the
CPU (every step of a run but the look for a card) comes out correct, and
comes out not correct with each fault the cell can have planted under
its timed path, and with the control (the reference in TF32, emulated on
the CPU, put in the program's place), each held to the cell's own
limits.  The control on the card, at the same size: the ``gpu`` test."""
import pytest
import torch

from portbench import faults, harness
from portbench.tests.small import CELLS, files

SEED = 2**31 + 17


def _run(workload, seed=SEED, device="cpu", **kw):
    return harness.run_cell(workload, seed, 0.2, False, device=device,
                            files=files(workload), **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result, checks = _run(workload)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


def _cases():
    for w in CELLS:
        driver = files(w)["traffic"]["driver"]
        for name in faults.FAULTS_OF[driver]:
            yield w, name


@pytest.mark.parametrize("workload,fault", list(_cases()))
def test_fault_makes_the_run_not_correct(workload, fault):
    with faults.FAULTS[fault]():
        result, checks = _run(workload)
    assert not result["correct"], checks


def _control(family, cfg, traffic, seed, device):
    """The reference in TF32 in the program's place: the run's own steps
    are replaced by it."""
    return harness.reference_record(family, cfg, traffic, seed, device,
                                    prec="tf32")


def _control_numbers(workload, device):
    import importlib

    from portbench.yardstick import compare

    f = files(workload)
    cfg, traffic = f["config"], f["traffic"]
    family = importlib.import_module(f"portbench.families.{cfg['family']}")
    ctl = _control(family, cfg, traffic, SEED, device)
    ref = harness.reference_record(family, cfg, traffic, SEED, device)
    return compare.judge(compare.numbers(ctl, ref), f["limits"])


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    correct, checks = _control_numbers(workload, "cpu")
    assert not correct, checks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 products exist only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_on_the_card_is_not_correct(workload, cuda):
    correct, checks = _control_numbers(workload, cuda)
    assert not correct, checks
