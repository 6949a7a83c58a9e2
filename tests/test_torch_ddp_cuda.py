"""The global-batch BatchNorm and top-k of ``codeps_torch/parallel`` on a
CUDA card: 2 ranks share card 0 over gloo (``tests/_ddp_worker.py
parts_cuda``) and are held against one process on the same card, as
``tests/test_torch_ddp.py`` holds the CPU path. Train-mode BatchNorm then
runs torch's SyncBN kernels (``models/resnet._GlobalBatchNormCuda``),
which have no CPU version, and the one process cuDNN's:

  - BatchNorm over 2 ranks x 2 rows against one process on the 4:
    output, input gradient and running statistics within 1e-12 in
    float64, 1e-5 in float32, and within two bfloat16 steps of the
    largest value for a bfloat16 input with float32 parameters (as under
    autocast; the statistics in float32, 1e-5);
  - the top-k semantic loss, its threshold inside a tie: the value within
    1e-6 relative, each rank's gradient exactly twice the one-process
    gradient of its rows (``tests/test_torch_ddp.py`` says why).

Run on the card with ``python -m pytest --noconftest -m gpu
tests/test_torch_ddp_cuda.py``; imports no JAX.
"""

import pytest
import torch

import _ddp_worker as worker
from codeps_torch import parallel

pytestmark = [pytest.mark.gpu, pytest.mark.skipif(
    not torch.cuda.is_available(), reason="needs a CUDA card")]

TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5}
STAT_TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5,
                  torch.bfloat16: 1e-5}
TOP_K_REL = 1e-6


@pytest.fixture(scope="module")
def parts_cuda(tmp_path_factory):
    return worker.spawn("parts_cuda", tmp_path_factory.mktemp("ddp_cuda"))


def _max_diff(ours, ref):
    return float((ours.double() - ref.double()).abs().max())


@pytest.mark.parametrize("dtype", worker.CUDA_BN_DTYPES, ids=str)
def test_batch_norm_cuda_matches_one_process(parts_cuda, dtype):
    x, grad_out, *_ = worker.parts_inputs()
    out, grad, mean, var = (t.cpu() for t in worker.run_batch_norm(
        x.cuda().to(dtype), grad_out.cuda().to(dtype)))
    for rank, result in enumerate(parts_cuda):
        rows = parallel.shard_rows(len(x), rank, 2)
        r_out, r_grad, r_mean, r_var = result["batch_norm"][str(dtype)]
        assert r_out.dtype == r_grad.dtype == dtype
        for ours, ref in ((r_out, out[rows]), (r_grad, grad[rows])):
            tol = TOLERANCE.get(dtype) or 2 * 2.0 ** -7 * float(
                ref.abs().max())
            assert _max_diff(ours, ref) <= tol
        assert _max_diff(r_mean, mean) <= STAT_TOLERANCE[dtype]
        assert _max_diff(r_var, var) <= STAT_TOLERANCE[dtype]


def test_top_k_semantic_loss_cuda_matches_one_process(parts_cuda):
    _, _, probs, target, weights = worker.parts_inputs()
    ref_loss, ref_grad = (t.cpu() for t in worker.run_semantic_loss(
        probs.cuda(), target.cuda(), weights.cuda()))
    for rank, result in enumerate(parts_cuda):
        rows = parallel.shard_rows(len(probs), rank, 2)
        loss, grad = result["semantic"]
        assert abs(float(loss) - float(ref_loss)) \
            <= TOP_K_REL * float(ref_loss)
        assert torch.equal(grad, 2 * ref_grad[rows])
