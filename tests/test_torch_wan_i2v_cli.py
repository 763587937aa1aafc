"""Image to video through the port's inference CLI, on the CPU.

* ``read_image`` gives a PNG's RGB pixels exactly, for each colour type and
  each row filter pillow writes (the CLI's first frame);
* ``--preset wan-i2v-tiny --image PATH`` generates a clip from that frame
  (resized to the preset's size) through ``generate``, and without
  ``--image`` from a frame drawn from ``--seed``: the two clips differ, and
  the same seed gives the same clip;
* the text-to-video presets refuse nothing they took before, and an
  image-to-video pipeline refuses a call without its image.
"""

import numpy as np
import pytest
import torch

from blade_torch.cli import inference as cli
from blade_torch.utils.video_io import read_image

PIL = pytest.importorskip("PIL.Image")


def _pixels(seed=0, h=13, w=17):
    rng = np.random.default_rng(seed)
    a = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    a[:, :5] = 40  # flat runs: pillow's filter choice varies by row
    a[6:] = np.cumsum(a[6:], axis=1, dtype=np.uint8)
    return a


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_read_image_gives_a_pngs_pixels(tmp_path, mode):
    a = _pixels()
    arrays = {"RGB": a, "RGBA": np.concatenate([a, a[..., :1]], -1), "L": a[..., 0],
              "LA": np.stack([a[..., 0], a[..., 1]], -1)}
    path = tmp_path / "x.png"
    PIL.fromarray(arrays[mode], mode).save(path, optimize=True)
    want = a if mode in ("RGB", "RGBA") else np.repeat(a[..., :1], 3, -1)
    got = read_image(str(path))
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_read_image_refuses_what_is_not_a_png(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_image(str(path))


def _clip(tmp_path, name, *extra):
    out = tmp_path / name
    cli.main(["--preset", "wan-i2v-tiny", "--random-init", "--device", "cpu", "--prompt",
              "a cat", "--steps", "2", "--output_dir", str(out), *extra])
    (written,) = list(out.iterdir())
    return written


def _frames(path):
    if path.suffix == ".npy":
        return np.load(path)
    import imageio.v3 as iio

    return np.asarray(iio.imread(path))


def test_the_cli_animates_a_png_and_a_seeded_frame(tmp_path):
    png = tmp_path / "first.png"
    PIL.fromarray(_pixels(1, 40, 24)).save(png)  # resized to the preset's 32 x 32
    from_png = _frames(_clip(tmp_path, "png", "--image", str(png)))
    seeded = _frames(_clip(tmp_path, "seeded"))
    again = _frames(_clip(tmp_path, "again"))
    assert from_png.shape[-3:-1] == seeded.shape[-3:-1] == (32, 32)
    assert np.array_equal(seeded, again) and not np.array_equal(from_png, seeded)


def test_an_i2v_pipeline_refuses_a_call_without_its_image():
    args = cli.get_args(["--preset", "wan-i2v-tiny", "--random-init", "--device", "cpu"])
    pipe = cli.build_pipeline(args)
    text = cli.random_text_embeds(pipe, "a cat")
    image, feats = cli.image_inputs(pipe, None, 3)
    assert image.shape == (1, 3, 32, 32) and feats.shape == (1, 9, 48)
    assert float(image.min()) >= -1.0 and float(image.max()) <= 1.0
    with pytest.raises(ValueError, match="image"):
        pipe.generate(text, generator=torch.Generator().manual_seed(0), num_steps=1)
    with pytest.raises(ValueError, match="image"):
        pipe.generate(text, generator=torch.Generator().manual_seed(0), num_steps=1,
                      image=image)
