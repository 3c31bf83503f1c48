"""Helpers for inspecting image pairs: names of pairs, side-by-side pair
images annotated with their distance, and the condensed same-class label
vector of pair classifiers. PIL is imported only where an image is made.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from facenet_tpu_torch import ioutils


def file2text(file):
    """'<class_dir>/<stem>' identifier of an image path."""
    p = Path(str(file))
    return str(Path(p.parent.name) / p.stem)


def generate_filename(dirname, value, file1, file2):
    """Filename for a rendered pair image: class/stem of both images plus
    the distance; the class dir appears once when both images share it."""
    p1, p2 = Path(str(file1)), Path(str(file2))
    left = f'{p1.parent.name}|{p1.stem}'
    right = (p2.stem if p1.parent.name == p2.parent.name
             else f'{p2.parent.name}|{p2.stem}')
    return str(Path(str(dirname)) / f'{left} & {right} & {value:2.3f}.png')


def _annotation_font(size):
    """A truetype font if one is installed, PIL's builtin bitmap otherwise."""
    from PIL import ImageFont
    for name in ('LiberationSans-Regular.ttf', 'DejaVuSans.ttf',
                 'arial.ttf'):
        try:
            return ImageFont.truetype(name, size)
        except OSError:
            continue
    return ImageFont.load_default()


class ConcatenateImages:
    """Two face crops side by side, annotated with their names and
    distance: the picture of a misclassified pair."""

    def __init__(self, file1, file2, distance, font_size=13):
        from PIL import Image, ImageDraw

        self.file1 = file1
        self.file2 = file2
        self.distance = distance

        panels = [ioutils.read_image(f) for f in (file1, file2)]
        self.img = Image.fromarray(np.concatenate(panels, axis=1))

        caption = (f'{file2text(file1)} & {file2text(file2)}\n'
                   f'{distance:2.3f}')
        ImageDraw.Draw(self.img).text((0, 0), caption, fill=(0, 255, 0),
                                      font=_annotation_font(font_size))

    def save(self, outdir):
        target = generate_filename(outdir, self.distance, self.file1,
                                   self.file2)
        ioutils.write_image(self.img, target)
        return target


def label_array(labels):
    """Condensed same-class indicator over all unordered index pairs:
    entry k is 1 when pair k (in `np.triu_indices` order, scipy's `pdist`
    convention) joins two samples of the same class."""
    if not isinstance(labels, (list, np.ndarray)):
        raise ValueError('label_array: labels must be a list or ndarray')
    labels = np.asarray(labels).reshape(-1)
    i, k = np.triu_indices(labels.size, k=1)
    return (labels[i] == labels[k]).astype(np.uint8)
