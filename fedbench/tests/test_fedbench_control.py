"""The control and the planted faults on the card, at the cells' own size,
each driven through the harness in the program's place and judged by the
check as a run is: the program's round with TF32 on, with half of each
client's rows left out, and with one label altered must each come out
not correct. Marked ``cuda``; the card's command:
``python3 -m pytest -q -m cuda fedbench/tests``."""
import pytest

from fb_helpers import CELLS

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("kind", ["control", "half_batch", "token"])
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_are_not_correct(name, kind, cuda_device):
    import torch
    from fedbench import cell as fcell
    from fedbench.readings import run_readings
    vals, ok = run_readings(fcell.load(name), 2 ** 31 + 901, kind,
                            cuda_device)
    torch.cuda.empty_cache()
    assert not ok, vals
