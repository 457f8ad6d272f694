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


@pytest.mark.skipif(not os.path.isdir(train_sage_digits.DATA),
                    reason="dataset not built")
def test_digits_int8_store_accuracy_parity(tmp_path):
    """Twin of ``tests/test_real_digits.py::
    test_digits_int8_store_accuracy_parity``: train once on raw features
    (the config above), then evaluate the same weights on the raw
    features and through an int8 feature store, served from the DRAM
    stager (split 0.0) and from the device (split 1.0).  The bounded
    per-column error must not move accuracy by more than half a point,
    and the two int8 routes must give the same ``x`` bit for bit."""
    args = train_sage_digits.parse_args([
        "--device", "cpu", "--epochs", "12", "--batch-size", "256",
        "--fanout", "10", "5", "--hidden", "64", "--lr", "3e-3",
        "--group", "2", "--no-auto-cap"])
    run = train_sage_digits.train(args)
    par = train_sage_digits.int8_store_parity(run, str(tmp_path))
    assert abs(par["acc_raw"] - par["acc_int8_split0"]) <= 0.005, par
    assert abs(par["acc_raw"] - par["acc_int8_split1"]) <= 0.005, par
    assert par["x_equal"], par
