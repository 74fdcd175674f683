"""K3, the row gather (ops/gather.py), against the JAX package's Pallas
kernel run in interpret mode (tests/test_eig3.py's shapes). A gather only
moves bytes, so the outputs must be equal bit for bit. On the CPU the
wrapper runs its plain version; the CUDA kernel is held against that
plain version on the card (tests/test_torch_cuda.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fast_livo2_tpu.ops.pallas_gather import gather_rows as jax_gather_rows
from fast_livo2_tpu_torch.ops import gather


def _case(C, W, N, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(C, W)).astype(np.float32)
    idx = rng.integers(0, C, N).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("C,W,N,group", [(2048, 128, 512, 64),
                                         (2048, 13, 512, 64),
                                         (300, 4, 256, 128)],
                         ids=["test_eig3_shape", "odd_width", "narrow"])
def test_gather_rows_matches_pallas_kernel_exactly(C, W, N, group):
    table, idx = _case(C, W, N)
    want = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(idx),
                                      group=group, interpret=True))
    before = gather.LAUNCHES
    got = gather.gather_rows(torch.from_numpy(table), torch.from_numpy(idx),
                             group=group)
    assert gather.LAUNCHES == before  # the CPU runs the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (N, W)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[idx])


def test_gather_rows_contract_errors():
    table, idx = _case(64, 8, 96)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    with pytest.raises(ValueError, match="multiple of group"):
        gather.gather_rows(t, i, group=64)  # the TPU wrapper asserts here
    with pytest.raises(ValueError):
        gather.gather_rows(t[0], i, group=32)
    # Indices outside [0, C): the plain version's indexing raises (the
    # kernels leave such rows undefined and do not check).
    bad = i.clone()
    bad[5] = 64
    with pytest.raises(IndexError):
        gather.gather_rows(t, bad, group=32)
