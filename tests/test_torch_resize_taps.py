"""The host-side tables of the logits resize kernel (kernel 4 of the port,
`csrc/resize_x2.cu`) on the CPU.

The kernel reads its column taps from a chunk-major table (8 output columns
a thread) and stages, per block, the input rows of a band of output rows.
These tests hold the table to `interp_taps`, the band sizing to every band
the kernel forms, and a numpy emulation of the kernel's blocks (bands,
chunks, H contraction first) to the plain version at fp32."""

import numpy as np
import pytest
import torch

from mspl_tpu_torch.ops.resize import interp_taps
from mspl_tpu_torch.ops.resize_x2 import (MAX_ROWS, chunk_taps,
                                          resize_x2_cm_plain, row_bands)

SIZES = [((128, 240), (256, 480)), ((37, 53), (101, 77)),
         ((20, 31), (45, 16)), ((1, 3), (5, 7))]


@pytest.mark.parametrize("hw_in,hw_out", SIZES)
def test_chunk_taps_hold_interp_taps(hw_in, hw_out):
    """Entry [t, j, c] is tap t of output column 8c + j, zero past the
    end."""
    wi, wo = hw_in[1], hw_out[1]
    ci, cw = chunk_taps(wi, wo)
    chunks = -(-wo // 8)
    assert ci.shape == cw.shape == (2, 8, chunks)
    idx, wgt = interp_taps(wi, wo)
    for t in range(2):
        np.testing.assert_array_equal(ci[t].T.reshape(-1)[:wo], idx[:, t])
        np.testing.assert_array_equal(cw[t].T.reshape(-1)[:wo], wgt[:, t])
        assert not ci[t].T.reshape(-1)[wo:].any()
        assert not cw[t].T.reshape(-1)[wo:].any()


@pytest.mark.parametrize("hw_in,hw_out", SIZES)
def test_resize_blocks_match_plain(hw_in, hw_out):
    """Every block's staged rows fit the sized capacity, and the outputs
    formed as the kernel forms them (staged band, chunk taps, H first,
    then W) equal the plain version at fp32 within 1e-5."""
    (hi, wi), (ho, wo) = hw_in, hw_out
    rng = np.random.default_rng(hi * wi)
    x = rng.normal(0, 3, (2, 3, hi, wi)).astype(np.float32)
    rb, cap = row_bands(hi, ho, wi, 4)
    assert 1 <= rb <= MAX_ROWS
    hidx, hwgt = interp_taps(hi, ho)
    ci, cw = chunk_taps(wi, wo)
    out = np.zeros((2, 3, ho, wo), np.float32)
    for oy0 in range(0, ho, rb):
        rows = range(oy0, min(oy0 + rb, ho))
        r0, r1 = hidx[oy0, 0], hidx[rows[-1], 1]
        assert (r1 - r0 + 1) * wi <= cap
        band = x[:, :, r0:r1 + 1]
        for oy in rows:
            c = (hwgt[oy, 0] * band[:, :, hidx[oy, 0] - r0]
                 + hwgt[oy, 1] * band[:, :, hidx[oy, 1] - r0])
            for cc in range(ci.shape[2]):
                for j in range(8):
                    ox = 8 * cc + j
                    if ox < wo:
                        ca = c[:, :, ci[0, j, cc]]
                        cb = c[:, :, ci[1, j, cc]]
                        wa, wb = cw[0, j, cc], cw[1, j, cc]
                        out[:, :, oy, ox] = wa * ca + wb * cb
    want = resize_x2_cm_plain(torch.from_numpy(x), (ho, wo)).numpy()
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
