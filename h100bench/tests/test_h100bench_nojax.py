"""No module that the harness or the reference loads is JAX or the JAX
package, compared by whole top-level name: the port's own name begins
with the JAX package's."""

import subprocess
import sys
import textwrap

import h100bench_cases as hc

from benchlib import nojax


def test_whole_top_level_names():
    assert nojax.forbidden(["ssd_tensorflow_tpu_torch", "ssd_tensorflow_tpu_torch.ops"]) == []
    assert nojax.forbidden(["ssd_tensorflow_tpu.ops.nms"]) == ["ssd_tensorflow_tpu"]
    assert nojax.forbidden(["jax.numpy", "jaxlib", "flax.linen", "jaxtyping"]) == [
        "flax", "jax", "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = textwrap.dedent(f"""
        import sys, tempfile
        from pathlib import Path
        sys.path[:0] = [{str(hc.BENCH / 'tests')!r}]
        import h100bench_cases as hc
        from benchlib import harness, nojax
        bundles = hc.write_bundles(Path({str(tmp_path)!r}))
        for w in ("vgg512-int8-serve-b64", "vgg512-bf16-train-b32", "resnet320-int8-serve-b64"):
            harness.run_cell(hc.ROOT, w, 11, 0.3, True, "cpu", cell=hc.cell(w, bundles))
        import reference.ssd_ref, reference.ssd_resnet34gn, calibrate
        print("FORBIDDEN", nojax.forbidden(sys.modules))
    """)
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "TMPDIR": str(tmp_path),
           "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(hc.ROOT), env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout
