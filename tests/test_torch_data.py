"""The port's host data path and the other JAX-free modules it copies:
each copy equals the JAX module below its docstring, apart from the
package name in imports, and the port's Loader yields the JAX Loader's
batches bit for bit."""

import pathlib

import numpy as np
import pytest

from tokenreduction_tpu.data import Loader as JaxLoader
from tokenreduction_tpu.data import ShardedSampler as JaxSampler
from tokenreduction_tpu.data import TransformConfig as JaxTransformConfig
from tokenreduction_tpu.data import build_dataset as jax_build_dataset
from tokenreduction_tpu.data import make_transform as jax_make_transform
from tokenreduction_tpu_torch.data import (
    Loader,
    ShardedSampler,
    TransformConfig,
    build_dataset,
    make_transform,
)
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]

COPIES = ["data/__init__.py", "data/transforms.py", "data/sampler.py",
          "data/datasets.py", "data/cache.py", "data/pipeline.py",
          "utils/metrics.py", "evaluation/run_table.py"]


def body(text: str) -> str:
    """The text below the module docstring (all of it when there is
    none)."""
    if text.startswith('"""'):
        return text[text.index('"""', 3) + 3:]
    return text


def jax_imports(text: str) -> str:
    """The port's import lines with the JAX package's name."""
    return "".join(
        line.replace("tokenreduction_tpu_torch", "tokenreduction_tpu")
        if line.lstrip().startswith(("from ", "import ")) else line
        for line in text.splitlines(keepends=True))


@pytest.mark.parametrize("path", COPIES)
def test_module_is_a_verbatim_copy(path):
    """Copied, not imported (importing the JAX package loads Flax): below
    the docstring the files are equal, the package name in imports
    aside, and the copy imports nothing of the JAX package."""
    port = (REPO / "tokenreduction_tpu_torch" / path).read_text()
    ref = (REPO / "tokenreduction_tpu" / path).read_text()
    assert jax_imports(body(port)) == body(ref)
    assert "tokenreduction_tpu." not in port
    assert "jax" not in body(port)


LOADERS = {
    "synthetic 64 px": dict(dataset="synthetic", n=20, size=64, batch=8),
    "synthetic crop 0.875 padded": dict(dataset="synthetic", n=13, size=48,
                                        batch=8, pad=True, crop_pct=0.875),
    "synthetic_multilabel 64 px padded": dict(
        dataset="synthetic_multilabel", n=11, size=64, batch=4, pad=True),
    "synthetic two workers": dict(dataset="synthetic", n=12, size=32,
                                  batch=5, workers=2),
}


def batches(build, sampler, loader, tcfg, transform, case):
    ds, _ = build("", case["dataset"], "val", num_classes=9,
                  img_size=case["size"], synthetic_n=case["n"])
    cfg = tcfg(input_size=case["size"],
               crop_pct=case.get("crop_pct", 0.875))
    it = loader(ds, sampler(len(ds), 1, 0, shuffle=False), case["batch"],
                transform(case["dataset"], False, cfg),
                pad_partial=case.get("pad", False),
                num_workers=case.get("workers", 0))
    return [dict(b, names=[ds.image_name(int(i)) for i in b["index"]
                           if i >= 0]) for b in it]


@pytest.mark.parametrize("case", sorted(LOADERS))
def test_loader_matches_jax(case):
    """The eval transforms (resize + center crop at crop_pct, or the
    multilabel square resize) over the synthetic sets: every batch's
    images, labels, indices, valid counts and image names equal JAX's."""
    c = LOADERS[case]
    got = batches(build_dataset, ShardedSampler, Loader, TransformConfig,
                  make_transform, c)
    want = batches(jax_build_dataset, JaxSampler, JaxLoader,
                   JaxTransformConfig, jax_make_transform, c)
    assert len(got) == len(want) == -(-c["n"] // c["batch"])
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["image"].dtype == np.float32
        assert g["image"].shape == (c["batch"] if c.get("pad") else
                                    g["valid"], c["size"], c["size"], 3)
        for key in ("image", "label", "index"):
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        assert g["valid"] == w["valid"] and g["names"] == w["names"]
    assert sum(g["valid"] for g in got) == c["n"]
