"""The host's choice for the probe's matmul kernel (``csrc/probe_dot.cu``),
through its Python mirror ``ops/probe_dot.py::plan``, on the CPU: which
producer fills the ring (TMA needs every global row a multiple of 16 bytes
on a 16-byte aligned base, else cp.async), which route the shape takes, and
that the blocks of the persistent grid cover every output tile exactly
once. ``chip_smoke.py`` holds the mirror equal to the kernel's own
``probe_dot_plan`` on the card."""

import numpy as np
import pytest

from chip_smoke import PROBE_DOT_CASES
from segmentron_tpu_torch.ops.probe_dot import H100_SMS, block_tiles, plan

# (M, K, N, int8) -> (route, producer): the 16-byte rule on x's rows (K
# elements) and, in bf16, w's rows (N elements); int8 w goes through the
# block's transposed stripe, never TMA.
EXPECTED = {
    (8192, 728, 728, True): ("wgmma", "cp.async"),   # 728-byte rows
    (8192, 728, 728, False): ("wgmma", "tma"),       # 1456 = 91 * 16
    (8192, 768, 768, True): ("wgmma", "tma"),
    (8192, 768, 768, False): ("wgmma", "tma"),
    (300, 40, 72, True): ("wgmma", "cp.async"),      # 40-byte rows
    (300, 40, 72, False): ("wgmma", "tma"),          # 80 and 144 bytes
    (129, 33, 17, True): ("wgmma", "cp.async"),      # odd rows
    (129, 33, 17, False): ("wgmma", "cp.async"),
    (520, 1000, 200, True): ("mma.sync", "cp.async"),  # K > 768: no room for the stripe
    (520, 1000, 200, False): ("wgmma", "tma"),
}
ALIGNED = 1 << 20  # a base address as torch's allocator gives it


def test_expected_covers_the_smoke_cases():
    assert {(m, k, n) for m, k, n, _ in EXPECTED} == set(PROBE_DOT_CASES)


@pytest.mark.parametrize("case", list(EXPECTED), ids=lambda c: "x".join(map(str, c[:3]))
                         + ("-int8" if c[3] else "-bf16"))
def test_route_follows_the_16_byte_rule(case):
    m, k, n, int8 = case
    p = plan(m, k, n, int8, ALIGNED, ALIGNED)
    assert (p["route"], p["producer"]) == EXPECTED[case]
    es = 1 if int8 else 2
    rows_ok = (k * es) % 16 == 0 and (int8 or (n * es) % 16 == 0)
    assert (p["producer"] == "tma") == (p["route"] == "wgmma" and rows_ok)
    if p["route"] == "wgmma":
        assert p["grid"] <= H100_SMS or p["per"] == 1


def test_misaligned_base_takes_cp_async():
    """A base 8 bytes off a 16-byte boundary (a slice of a larger tensor)
    cannot be a TMA base: the cp.async producer takes it, 8 bytes a copy."""
    p = plan(8192, 768, 768, False, ALIGNED + 8, ALIGNED)
    assert p["producer"] == "cp.async" and p["vec_a"] == 8


@pytest.mark.parametrize("sms", [H100_SMS, 5])
@pytest.mark.parametrize("m,k,n", PROBE_DOT_CASES)
def test_tiles_cover_every_output_once(m, k, n, sms):
    for int8 in (True, False):
        p = plan(m, k, n, int8, ALIGNED, ALIGNED, sms)
        bm, bn = p["tile"]
        hits = np.zeros((p["m_tiles"] * bm, p["n_tiles"] * bn), np.int32)
        for block in range(p["grid"]):
            for r, c in block_tiles(p, block):
                hits[r:r + bm, c:c + bn] += 1
        assert (hits[:m, :n] == 1).all() and hits.sum() == hits.size
