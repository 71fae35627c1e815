"""PyTorch port: it stands on its own.

- No file of `cell_image_analysis_tpu_torch/`, nor `chip_smoke.py`,
  `scripts/profile_torch_port.py`, `scripts/clahe_bands.py`,
  `scripts/cc_split.py` or `scripts/cc_ablate.py`, imports
  `jax` or anything of the JAX package (an AST scan, one case a file).
- The port's `SegConfig` has the JAX defaults, field for field, and leaves
  out only the JAX package's TPU knobs.
- The port's synthetic frames are byte-equal to the JAX package's.
- The entry points that own tensors put them on the card by default, and
  raise where there is none unless the caller passes `device="cpu"`.
"""

import ast
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import torch_threads

torch_threads()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT_FILES = sorted(
    [os.path.relpath(p, _REPO) for p in
     glob.glob(os.path.join(_REPO, "cell_image_analysis_tpu_torch", "**", "*.py"), recursive=True)]
    + ["chip_smoke.py", os.path.join("scripts", "profile_torch_port.py"),
       os.path.join("scripts", "clahe_bands.py"), os.path.join("scripts", "cc_split.py"),
       os.path.join("scripts", "cc_ablate.py")])
_FORBIDDEN = ("jax", "jaxlib", "flax", "cell_image_analysis_tpu")
_TPU_KNOBS = {"unet_dtype", "unet_precision", "unet_lvl0_precision", "unet_lvl0_s2d",
              "unet_wb16", "unet_hilo", "unet_winograd"}


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", _PORT_FILES)
def test_port_file_imports_no_jax(path):
    with open(os.path.join(_REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [m for m in _imported_modules(tree) if m.split(".")[0] in _FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_the_scan_covers_the_port():
    assert len(_PORT_FILES) >= 30
    assert "cell_image_analysis_tpu_torch/config.py" in _PORT_FILES
    assert "cell_image_analysis_tpu_torch/utils/synthetic.py" in _PORT_FILES
    tree = ast.parse("import jax.numpy as jnp\nfrom cell_image_analysis_tpu.config import X\n")
    assert list(_imported_modules(tree)) == ["jax.numpy", "cell_image_analysis_tpu.config"]


def _port_fields():
    from cell_image_analysis_tpu_torch.config import SegConfig

    return [f.name for f in dataclasses.fields(SegConfig)]


@pytest.mark.parametrize("name", _port_fields())
def test_seg_config_default_equals_jax(name):
    from cell_image_analysis_tpu.config import SegConfig as JaxSegConfig
    from cell_image_analysis_tpu_torch.config import SegConfig

    assert getattr(SegConfig(), name) == getattr(JaxSegConfig(), name)


def test_seg_config_leaves_out_only_the_tpu_knobs():
    from cell_image_analysis_tpu.config import SegConfig as JaxSegConfig
    from cell_image_analysis_tpu_torch.config import SegConfig

    jax_fields = {f.name for f in dataclasses.fields(JaxSegConfig)}
    assert jax_fields - set(_port_fields()) == _TPU_KNOBS
    assert set(_port_fields()) <= jax_fields
    with pytest.raises(dataclasses.FrozenInstanceError):
        SegConfig().n_rays = 3


@pytest.mark.parametrize("seed,size,n_cells,mutant", [(7, 96, 3, 0.0), (11, 128, 6, 0.5),
                                                      (3, 200, 9, 1.0)])
def test_make_frame_byte_equal(seed, size, n_cells, mutant):
    from cell_image_analysis_tpu.utils.synthetic import make_frame as jax_make
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame

    a = make_frame(np.random.default_rng(seed), size=size, n_cells=n_cells,
                   mutant_fraction=mutant)
    b = jax_make(np.random.default_rng(seed), size=size, n_cells=n_cells,
                 mutant_fraction=mutant)
    assert a.dtype == b.dtype == np.uint16 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed,size,n_cells,clustering", [(7, 128, 5, 0.0), (4, 160, 12, 0.5),
                                                          (9, 256, 20, 0.9)])
def test_make_frame_instances_byte_equal(seed, size, n_cells, clustering):
    from cell_image_analysis_tpu.utils.synthetic import make_frame_instances as jax_make
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame_instances

    fa, la = make_frame_instances(np.random.default_rng(seed), size=size, n_cells=n_cells,
                                  clustering=clustering)
    fb, lb = jax_make(np.random.default_rng(seed), size=size, n_cells=n_cells,
                      clustering=clustering)
    assert fa.tobytes() == fb.tobytes()
    assert la.dtype == lb.dtype and la.tobytes() == lb.tobytes()
    assert int(la.max()) > 0


def test_stardist_backend_defaults_to_the_card():
    from cell_image_analysis_tpu_torch.io.artifacts import load_unet_variables
    from cell_image_analysis_tpu_torch.models.segmentation import StarDistBackend

    variables = load_unet_variables()
    if torch.cuda.is_available():
        backend = StarDistBackend(variables)
        assert next(backend.model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StarDistBackend(variables)
    backend = StarDistBackend(variables, device="cpu")
    assert next(backend.model.parameters()).device.type == "cpu"


def test_scoring_params_default_to_the_card():
    from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params

    if torch.cuda.is_available():
        model, params = load_scoring_params()
        assert params.pca_mean.device.type == "cuda"
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_scoring_params()
    model, params = load_scoring_params(device="cpu")
    assert params.pca_mean.device.type == "cpu"
    assert next(model.parameters()).device.type == "cpu"
