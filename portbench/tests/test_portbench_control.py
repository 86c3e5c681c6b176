"""The map cell's control, the reference in the program's place with
distances over half of the bits (a broken exact 2-NN), fails the cell's
check; the program's own answers pass it. At a small size, on the CPU."""

import pytest
import torch

from conftest import SMALL
from portbench import harness


def _readings(cell, device, seed):
    c = harness.find_cell(cell)
    small = SMALL[cell]
    params = {**c.spec["params"], **small["params"]}
    driver = c.generator.Driver({**c.config, **small["config"]}, params,
                                seed, device, 0.1)
    try:
        driver.warm()
        first = params["warm_requests"]
        for i in range(first, first + params["control_requests"] + 1):
            driver.request(i)
        driver.free_program()
        return (driver.check(c.spec["limits"]),
                driver.check(c.spec["limits"], control=True))
    finally:
        driver.close()


def _fails(checks):
    return any(v["value"] > v["limit"] for v in checks.values())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_map_control_fails(seed):
    program, control = _readings("orbmap.seq00", torch.device("cpu"), seed)
    assert not _fails(program) and _fails(control)
