"""Kernel-vs-plain checks that need an NVIDIA card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these skip on a machine without a card;
``python3 chip_smoke.py`` runs the same comparisons at full size there.
Run them on the card with ``python -m pytest --noconftest
tests/test_torch_cuda.py -m cuda`` (the suite's conftest imports JAX, which
a GPU host need not have).  Max-plus is adds and maxes only: kernel and
plain version must agree bit for bit.
"""

import io

import numpy as np
import pytest
import torch

from cpgisland_tpu_torch import pipeline
from cpgisland_tpu_torch.models import presets
from cpgisland_tpu_torch.ops import _kernels
from cpgisland_tpu_torch.ops import viterbi_onehot as OH

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("bk,nb", [(8, 1), (64, 130), (4096, 257)])
def test_kernels_equal_plain_versions(cuda_device, bk, nb):
    rng = np.random.default_rng(bk + nb)
    params = presets.durbin_cpg8(device=cuda_device)
    steps = rng.integers(0, 5, size=(bk, nb)).astype(np.int32)
    resets = torch.from_numpy(rng.random((bk, nb)) < 0.01).to(cuda_device)
    steps_d = torch.from_numpy(steps).to(cuda_device)
    _, _, tab, idtab, pair2, _, _, _ = OH._prepared(params, steps_d, 1, resets)
    v = torch.from_numpy(rng.normal(size=(2, nb)).astype(np.float32)).to(cuda_device)
    bits = torch.from_numpy(rng.integers(0, 2, size=nb).astype(np.int32)).to(cuda_device)
    before = dict(_kernels.launches)
    assert torch.equal(OH.oh_products(pair2, tab), OH.oh_products_plain(pair2, tab))
    got = OH.oh_backpointers(pair2, v, tab)
    want = OH.oh_backpointers_plain(pair2, v, tab)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(OH.oh_backtrace(got[0], pair2, idtab, bits),
                       OH.oh_backtrace_plain(got[0], pair2, idtab, bits))
    torch.cuda.synchronize()
    assert all(_kernels.launches[k] == before[k] + 1 for k in before)


def test_decode_file_cuda_equals_cpu(cuda_device, tmp_path):
    rng = np.random.default_rng(3)
    p = tmp_path / "x.fa"
    with open(p, "w") as f:
        for r in range(3):
            s = rng.choice(4, size=20_000, p=[0.3, 0.2, 0.2, 0.3])
            s[5000:6500] = rng.choice(4, size=1500, p=[0.15, 0.35, 0.35, 0.15])
            f.write(f">r{r}\n" + "".join("ACGT"[x] for x in s) + "\n")
    outs = {}
    for dev in ("cpu", "cuda"):
        buf = io.StringIO()
        pipeline.decode_file(str(p), presets.durbin_cpg8(), islands_out=buf,
                             compat=False, device=dev)
        outs[dev] = buf.getvalue()
    assert outs["cpu"] == outs["cuda"] and outs["cuda"]
