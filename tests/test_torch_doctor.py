"""The port's environment preflight (``cli.doctor``): JAX's three cases
(``tests/test_doctor.py``) with ``--device cpu``, where the attention
kernels' half of the compile probe is a WARN naming the card they need;
without a card and without ``--device cpu``, a FAIL and exit code 1; and
the kernel probe's comparison against ``kernels.attention.BF16_TOL``, run
here on the plain version with the build stubbed (``nvcc`` builds it on a
card)."""

import pytest
import yaml

from avsl_tpu_torch.cli import doctor


def test_torch_doctor_passes_on_the_cpu(capsys):
    rc = doctor.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "torch device" in out and "audio kernels" in out
    assert "FAIL" not in out
    assert "[WARN] tiny compile + execute" in out and "H100" in out
    # OpenCV is here: the video chain's probe clip passes (JAX's 4 black
    # frames fall under validate_video's minimum size and always WARN)
    assert "[PASS] video IO fallback chain" in out


def test_torch_doctor_validates_config(tmp_path, capsys):
    cfg = {"model_name": "test", "check_output_dir": str(tmp_path / "ck"),
           "log_output_dir": str(tmp_path / "lg")}
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(cfg))
    doctor._RESULTS.clear()
    rc = doctor.main(["--config", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "c.yaml" in out and "writable: check_output_dir, log_output_dir" in out


def test_torch_doctor_fails_on_unreadable_config(tmp_path, capsys):
    doctor._RESULTS.clear()
    rc = doctor.main(["--config", str(tmp_path / "missing.yaml"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "[FAIL] config missing.yaml" in out


def test_torch_doctor_fails_without_a_card(capsys, monkeypatch):
    """The default device is the card: with none, the device check FAILs
    and the exit code is 1 (the CPU is never taken in its place)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = doctor.main([])
    out = capsys.readouterr().out
    assert rc == 1
    assert "[FAIL] torch device" in out and "CUDA is not available" in out
    assert "0 fail" not in out


@pytest.mark.parametrize("tol", [None, dict(atol=-1.0, rtol=0.0)],
                         ids=["bf16_tol", "limit_below_any_error"])
def test_torch_doctor_kernel_probe_builds_both_and_compares(monkeypatch, tol):
    """The probe holds the launch to ``kernels.attention.BF16_TOL``: a
    limit put there below any error fails it."""
    import torch

    from avsl_tpu_torch.kernels import _build, attention

    built = []
    monkeypatch.setattr(_build, "load_library", built.append)
    if tol is None:
        detail = doctor.kernel_probe(torch.device("cpu"))
        assert detail.startswith("kernels built; attention launch within")
    else:
        monkeypatch.setattr(attention, "BF16_TOL", tol)
        with pytest.raises(RuntimeError, match="differs from the plain version"):
            doctor.kernel_probe(torch.device("cpu"))
    assert built == ["flash_attn_fwd", "flash_attn_bwd"]
