"""The port's digits twin on the CPU: the pipeline of
``tests/test_real_digits.py::test_digits_knn_pipeline_accuracy`` (batch
256, fanout [10, 5], hidden 64, bf16 matmuls, Adam 3e-3, 12 epochs of
the scanned epoch at G = 2, uncapped sampler) must clear the same
``acc > 0.93`` floor on the in-repo sklearn digits k-NN graph."""
import json
import os

import pytest
import torch

from glt_tpu_torch.examples import train_sage_digits

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)


@pytest.mark.skipif(not os.path.isdir(train_sage_digits.DATA),
                    reason="dataset not built")
def test_digits_knn_pipeline_accuracy():
    with open(train_sage_digits.DATA / "META.json") as fh:
        assert json.load(fh)["source"] == "sklearn-digits-knn"
    acc = train_sage_digits.main([
        "--device", "cpu", "--epochs", "12", "--batch-size", "256",
        "--fanout", "10", "5", "--hidden", "64", "--lr", "3e-3",
        "--group", "2", "--no-auto-cap"])
    assert acc > 0.93, acc
