"""The port's host data path against the JAX package's: transforms, streams,
decoders, and the loader's order.

Transforms and streams are numpy on both sides and seeded alike, so they
are held equal to the bit. Decodes are held against the JAX package's own
readers on the same files: NIfTI against its numpy reader, equal to the
bit; PNG (8- and 16-bit grey, written with zlib) equal to the bit to its
native decoder's arithmetic (the sample times the f32 reciprocal of 255 or
65535) and within one f32 ulp of its PIL decode (`read_image(native=False)`,
which divides). The JAX package's native library is not used
here: it yields an epoch in completion order. The port's loader must yield
every epoch in file order, or in the seeded shuffle order, with 4 workers
and more; that is checked over 64 files and repeated epochs.
"""
from __future__ import annotations

import gzip
import os
import shutil
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from generativemodels_tpu.data import native as jax_native
from generativemodels_tpu.data import pipeline as jax_pipeline
from generativemodels_tpu.data import transforms as jax_transforms
from generativemodels_tpu_torch.data import native, pipeline, transforms
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FILES = 64
WORKERS = 4


def write_png(path, image: np.ndarray) -> None:
    """A grey PNG (16-bit for uint16, else 8-bit) with zlib, no image library."""
    height, width = image.shape
    depth = 16 if image.dtype == np.uint16 else 8
    rows = image.astype(">u2" if depth == 16 else np.uint8)
    raw = b"".join(b"\x00" + rows[y].tobytes() for y in range(height))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def order_dir(tmp_path_factory):
    """FILES NIfTI volumes whose every voxel is the file's index."""
    d = tmp_path_factory.mktemp("order")
    for i in range(FILES):
        native.write_nifti(str(d / f"v{i:03d}.nii"), np.full((4, 5, 6), i, np.float32))
    return str(d)


@pytest.fixture(scope="module")
def npy_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("npy")
    rng = np.random.default_rng(0)
    for i in range(12):
        shape = (20 + i % 3, 18 + i % 4)
        np.save(d / f"x{i:02d}.npy", (rng.random(shape) * 300).astype(np.float32))
    return str(d)


def _firsts(stream) -> list[int]:
    return [int(a.flat[0]) for a in stream]


@pytest.mark.parametrize("workers,max_queue", [(WORKERS, 8), (8, 1), (1, 2)])
def test_loader_keeps_file_order(order_dir, workers, max_queue):
    paths = pipeline._list_files(order_dir)
    for _ in range(10):
        with native.PrefetchLoader(paths, num_workers=workers, max_queue=max_queue) as loader:
            assert _firsts(loader) == list(range(FILES))


def test_file_dataset_keeps_file_order_over_epochs(order_dir):
    stream = pipeline.file_dataset(order_dir, num_workers=WORKERS)
    for _ in range(20):
        assert [int(next(stream).flat[0]) for _ in range(FILES)] == list(range(FILES))


def test_file_dataset_shuffle_is_the_seeded_order(order_dir):
    stream = pipeline.file_dataset(order_dir, shuffle=True, seed=11, num_workers=WORKERS)
    for epoch in range(5):
        want = list(range(FILES))
        np.random.RandomState(11 + epoch).shuffle(want)
        assert [int(next(stream).flat[0]) for _ in range(FILES)] == want


def test_looping_loader_wraps_in_order(order_dir):
    paths = pipeline._list_files(order_dir)[:5]
    loader = native.PrefetchLoader(paths, num_workers=WORKERS, max_queue=3, loop=True)
    it = iter(loader)
    assert [int(next(it).flat[0]) for _ in range(17)] == [i % 5 for i in range(17)]
    loader.close()


def test_unreadable_file_is_skipped_in_order(tmp_path, order_dir):
    for name in ("v000.nii", "v001.nii", "v002.nii"):
        shutil.copy(os.path.join(order_dir, name), tmp_path / name)
    (tmp_path / "v001.nii").write_bytes(b"not a nifti")
    assert _firsts(pipeline.file_dataset(str(tmp_path), loop=False)) == [0, 2]


@pytest.mark.parametrize("gz", [False, True])
def test_nifti_decode_matches_jax(tmp_path, gz):
    rng = np.random.default_rng(1)
    volume = (rng.standard_normal((7, 9, 11)) * 100).astype(np.float32)
    path = str(tmp_path / "vol.nii")
    native.write_nifti(path, volume)
    if gz:
        with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
            shutil.copyfileobj(f, g)
        path += ".gz"
    want = jax_native.read_nifti(path, native=False)
    for got in (native.read_nifti(path), native.read_nifti(path, native=False)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, volume)


@pytest.mark.parametrize("dtype,top", [(np.uint8, 255), (np.uint16, 65535)])
def test_png_decode_matches_jax(tmp_path, dtype, top):
    rng = np.random.default_rng(2)
    image = rng.integers(0, top + 1, (13, 17)).astype(dtype)
    path = str(tmp_path / "img.png")
    write_png(path, image)
    want = image.astype(np.float32) * np.float32(1.0 / top)
    np.testing.assert_array_equal(native.read_image(path), want)
    pil = jax_native.read_image(path, native=False)
    np.testing.assert_allclose(native.read_image(path), pil, rtol=1.2e-7, atol=0)
    np.testing.assert_array_equal(native.read_image(path, native=False), pil)
    np.testing.assert_array_equal(native.read_image(path, raw=True), image.astype(np.float32))
    # a label map keeps its raw class values, as the JAX reader does
    np.testing.assert_array_equal(pipeline._read_label(path), jax_pipeline._read_label(path))


def test_png_directory_in_file_order(tmp_path):
    for i in range(FILES):
        write_png(str(tmp_path / f"p{i:03d}.png"), np.full((4, 4), i, np.uint8))
    got = [float(a[0, 0]) for a in pipeline.file_dataset(str(tmp_path), loop=False)]
    assert got == [np.float32(i) * np.float32(1.0 / 255) for i in range(FILES)]


def test_missing_decoder_names_its_header(tmp_path, monkeypatch):
    path = str(tmp_path / "img.png")
    write_png(path, np.zeros((4, 4), np.uint8))
    monkeypatch.setattr(native.load_library(), "gmtpu_decoders", lambda: 2)  # JPEG only
    assert native.missing_decoder([path]) == "png.h"
    with pytest.raises(RuntimeError, match="png.h"):
        native.read_image(path)
    with pytest.raises(RuntimeError, match="png.h"):
        list(pipeline.file_dataset(str(tmp_path), loop=False))


def test_library_is_built_from_the_port_source():
    path = native.build_library()
    assert path.parent == native.BUILD_DIR and path.name.startswith("dataloader-")
    assert native.SOURCE.parent == native.PACKAGE_DIR / "csrc"


def test_several_processes_are_not_ported(order_dir):
    with pytest.raises(NotImplementedError, match="A11"):
        next(pipeline.file_dataset(order_dir, process_count=2, process_index=0))
    with pytest.raises(NotImplementedError, match="A11"):
        next(pipeline.paired_stream(order_dir, order_dir, (4, 4), process_count=2))


def _arrays(rng_seed, shape):
    return (np.random.default_rng(rng_seed).random(shape) * 50).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("scale_intensity", lambda a: (a,)),
    ("ensure_channel_first", lambda a: (np.moveaxis(a[:3], 0, -1), 2)),
    ("center_crop_or_pad", lambda a: (a, (16, 30))),
    ("resize", lambda a: (a, (11, 29))),
    ("fit_sample", lambda a: (a, (24, 16), "resize")),
    ("fit_sample", lambda a: (a, (24, 16), "crop_pad", False, 0)),
])
def test_transform_matches_jax(name, args):
    a = _arrays(3, (3, 20, 22))
    want = getattr(jax_transforms, name)(*args(a))
    got = getattr(transforms, name)(*args(a))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spatial_dims", [2, 3])
def test_random_transforms_match_jax(spatial_dims):
    shape = (2,) + (14,) * spatial_dims
    for seed in range(4):
        a = _arrays(seed, shape)
        kwargs = dict(rotate_range=0.3, translate_range=2.0, scale_range=0.1, prob=0.7,
                      spatial_dims=spatial_dims)
        want = jax_transforms.rand_affine(a, np.random.default_rng(seed), **kwargs)
        got = transforms.rand_affine(a, np.random.default_rng(seed), **kwargs)
        np.testing.assert_array_equal(got, want)
        roi = (9,) * spatial_dims
        np.testing.assert_array_equal(
            transforms.rand_spatial_crop(a, np.random.default_rng(seed), roi),
            jax_transforms.rand_spatial_crop(a, np.random.default_rng(seed), roi))


@pytest.mark.parametrize("cache,augment,fit", [(False, False, "crop_pad"), (True, True, "resize"),
                                               (False, True, "crop_pad")])
def test_training_stream_matches_jax(npy_dir, cache, augment, fit):
    kwargs = dict(fit=fit, cache=cache, augment=augment, seed=3)
    want = jax_pipeline.training_stream(npy_dir, (16, 16), **kwargs)
    got = pipeline.training_stream(npy_dir, (16, 16), **kwargs)
    for _ in range(30):  # two and a half epochs
        np.testing.assert_array_equal(next(got), next(want))


def test_paired_stream_matches_jax(tmp_path, npy_dir):
    labels = tmp_path / "labels"
    labels.mkdir()
    for i, path in enumerate(pipeline._list_files(npy_dir)):
        shape = np.load(path).shape
        np.save(labels / f"l{i:02d}.npy", (np.arange(np.prod(shape)) % 3).reshape(shape)
                .astype(np.float32))
    want = jax_pipeline.batched_pairs(
        jax_pipeline.paired_stream(npy_dir, str(labels), (16, 16), "resize", seed=4), 5)
    got = pipeline.batched_pairs(
        pipeline.paired_stream(npy_dir, str(labels), (16, 16), "resize", seed=4), 5)
    for _ in range(5):
        for g, w in zip(next(got), next(want)):
            np.testing.assert_array_equal(g, w)


def test_device_batches_on_the_cpu(npy_dir):
    batches = pipeline.device_batches(npy_dir, (16, 16), 4, cache=True, seed=3, device="cpu")
    want = jax_pipeline.batched(jax_pipeline.training_stream(npy_dir, (16, 16), cache=True,
                                                             seed=3), 4)
    for _ in range(4):
        got = next(batches)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), next(want).reshape(4, 1, 16, 16))
    batches.close()


def test_prefetch_to_device_keeps_order_and_raises():
    def source():
        for i in range(7):
            yield (np.full((2,), i), {"label": np.full((1,), -i)})
        raise ValueError("source failed")

    got = pipeline.prefetch_to_device(source(), size=3, device="cpu")
    for i in range(7):
        images, extra = next(got)
        assert int(images[0]) == i and int(extra["label"][0]) == -i
    with pytest.raises(ValueError, match="source failed"):
        next(got)


def test_loader_never_opens_the_jax_library():
    """The port's loader maps its own library, never the JAX package's
    native/libgmtpu_data.so."""
    code = (
        "import numpy as np, os, tempfile\n"
        "from generativemodels_tpu_torch.data import native, file_dataset\n"
        "d = tempfile.mkdtemp()\n"
        "native.write_nifti(os.path.join(d, 'a.nii'), np.zeros((2, 2), np.float32))\n"
        "list(file_dataset(d, loop=False))\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libgmtpu_data' not in maps, 'the JAX library is mapped'\n"
        "assert '/_build/dataloader-' in maps, 'the port library is not mapped'\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


RECIPES = {  # recipe: (argv at a tiny size, the data's spatial rank, batches drawn from files)
    "train_3d_ddpm": (["--steps", "2", "--batch", "1", "--size", "16", "--channels", "16", "32",
                       "--norm-groups", "8", "--head-channels", "32"], 3, 2),
    "train_vqgan": (["--steps", "2", "--warmup-steps", "1", "--batch", "2", "--size", "32",
                     "--channels", "8", "8"], 2, 2),
    "train_2d_ldm": (["--stage1-steps", "1", "--warmup-steps", "1", "--stage2-steps", "1",
                      "--batch", "2", "--size", "32"], 2, 3),
    "train_3d_ldm": (["--stage1-steps", "1", "--warmup-steps", "1", "--stage2-steps", "1",
                      "--batch", "1", "--size", "32"], 3, 3),
    "train_vqvae_transformer": (["--stage1-steps", "1", "--stage2-steps", "1", "--batch", "2",
                                 "--size", "16", "--num-embeddings", "8"], 2, 2),
    "train_spade_vae": (["--steps", "2", "--batch", "2", "--size", "32"], 2, 2),
    "train_spade_ldm": (["--stage1-steps", "1", "--warmup-steps", "1", "--stage2-steps", "1",
                         "--batch", "2", "--size", "32"], 2, 3),
}


@pytest.mark.parametrize("name", list(RECIPES))
def test_recipe_trains_from_files(name, tmp_path, monkeypatch):
    """Each training recipe's --data-dir flags take its batches from the files."""
    import importlib

    from generativemodels_tpu_torch import data

    argv, nd, batches = RECIPES[name]
    rng = np.random.default_rng(5)
    shape = (20, 18, 16) if nd == 3 else (40, 36)
    for i in range(4):
        np.save(tmp_path / f"x{i}.npy", (rng.random(shape) * 100).astype(np.float32))
    drawn = []
    paired = name.startswith("train_spade")
    wrapped = "paired_stream" if paired else "device_batches"
    original = getattr(data, wrapped)

    def counting(*args, **kwargs):
        for item in original(*args, **kwargs):
            drawn.append(item)
            yield item

    monkeypatch.setattr(data, wrapped, counting)
    flags = ["--data-dir", str(tmp_path)] + (["--label-dir", str(tmp_path)] if paired else
                                             ["--augment", "--cache"])
    importlib.import_module(f"generativemodels_tpu_torch.recipes.{name}").main(
        [*argv, *flags, "--device", "cpu"])
    # pairs are counted where the prefetch thread draws them: up to its 2
    # queued batches and 1 in hand beyond the ones the steps took
    per_batch = int(argv[argv.index("--batch") + 1]) if paired else 1
    ahead = 3 if paired else 0
    assert batches * per_batch <= len(drawn) <= (batches + ahead) * per_batch
