"""`repro_torch.nn.spec.init_params` draws a spec tree's leaves at the same
time, one thread a leaf: every leaf's values equal those of the serial
draw (the leaves one after another in one thread), bit for bit, and a
leaf's values are its own generator's, seeded by (seed, crc32(name)),
whatever the other leaves are."""

import zlib

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.lm import build_lm
from repro_torch.nn import spec as SP
from repro_torch.nn.cnn import resnet8
from repro_torch.nn.spec import flatten_with_names


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The draws' own arithmetic on one thread a leaf: beside the suite's
    parallel workers, more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spec_of(name):
    if name == "resnet8":
        return resnet8().spec
    return build_lm(get_config(name).scaled_down()).spec


@pytest.mark.parametrize("name", ["resnet8", "olmo-1b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_concurrent_draw_equals_the_serial_draw(monkeypatch, name):
    spec = spec_of(name)
    drawn = flatten_with_names(SP.init_params(3, spec, "cpu"))
    monkeypatch.setattr(SP, "INIT_THREADS", 1)
    serial = flatten_with_names(SP.init_params(3, spec, "cpu"))
    assert len(drawn) > 1 and drawn.keys() == serial.keys()
    for k, v in drawn.items():
        assert v.dtype == serial[k].dtype and torch.equal(v, serial[k]), k


def test_a_leaf_draws_from_its_own_generator():
    spec = spec_of("olmo-1b")
    leaf = spec["blocks"]["g0"]["attn"]["wq"]
    gen = torch.Generator().manual_seed(
        (5 * 1_000_003 + zlib.crc32(b"blocks/g0/attn/wq/")) % (1 << 63))
    want = leaf.init(gen, leaf.shape, leaf.dtype)
    got = SP.init_params(5, spec, "cpu")["blocks"]["g0"]["attn"]["wq"]
    assert torch.equal(got, want)
    alone = SP.init_params(5, {"blocks": {"g0": {"attn": {"wq": leaf}}}},
                           "cpu")["blocks"]["g0"]["attn"]["wq"]
    assert torch.equal(alone, want)
