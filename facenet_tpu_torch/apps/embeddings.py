"""Compute embeddings for every image of a dataset and save them to disk.

The output container follows the suffix of the output file: `.h5`
(``embeddings`` and ``labels``), `.npz` (numpy archive with the file
names) or `.tfrecord` (one tf.train.Example per image, utils/tfrecord.py).
Runs on the GPU unless ``--device cpu``. Under torchrun, with a ``mesh:``
section, the batches split over the ranks and data rank 0 writes the file.

    python -m facenet_tpu_torch.apps.embeddings --config my.yaml [--device cpu]
    torchrun --nproc-per-node N -m facenet_tpu_torch.apps.embeddings --config my.yaml

A `pipeline:` config section embeds RAW SCENES (un-cropped photos):
detection, alignment and the embedding forward run through `FacePipeline`
in one enqueue per batch, instead of extract_faces writing crops for this
app to read:

    pipeline:
      image_shape: [480, 640]   # letterbox geometry
      align: crop               # or 'landmarks' (5-point warp)
      margin: 0.2

Scenes with no detected face are dropped from the output (count logged).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from facenet_tpu_torch import config, dataset, facenet, h5utils, ioutils
from facenet_tpu_torch.parallel.mesh import join_torchrun, world


def save_h5(path, embeddings, labels, files):
    h5utils.write(path, 'embeddings', embeddings)
    h5utils.write(path, 'labels', labels)


def save_npz(path, embeddings, labels, files):
    np.savez(path, embeddings=embeddings, labels=labels,
             files=np.array(files))


def save_tfrecord(path, embeddings, labels, files):
    from facenet_tpu_torch.utils.tfrecord import write_embeddings_tfrecord
    write_embeddings_tfrecord(path, embeddings, labels, files)


WRITERS = {'.h5': save_h5, '.npz': save_npz, '.tfrecord': save_tfrecord}


def kept_rows(embeddings, valid, labels, files):
    """The scenes whose first face slot holds a detection.

    :param embeddings: [N, num_faces, D] pipeline embeddings
    :param valid: [N, num_faces] detection mask
    :return: (embeddings [M, D] of slot 0, labels [M], files [M], number of
        scenes dropped)
    """
    keep = np.asarray(valid)[:, 0]
    return (np.asarray(embeddings)[keep, 0], np.asarray(labels)[keep],
            [f for f, k in zip(files, keep) if k], int((~keep).sum()))


class PipelineEmbeddings:
    """Raw scenes -> embeddings through FacePipeline; rows whose scene
    gave no valid detection are dropped."""

    def __init__(self, dbase, options, device):
        from facenet_tpu_torch import FaceNet
        from facenet_tpu_torch.pipeline import FacePipeline

        pcfg = options.pipeline
        shape = tuple(int(v) for v in pcfg.image_shape) \
            if pcfg.image_shape else (480, 640)
        pipe = FacePipeline(
            FaceNet(options.model, device=device),
            image_shape=shape,
            align=str(pcfg.align or 'crop'),
            margin=config.value_or(pcfg.margin, 0.2))
        emb, _, valid = pipe.process_files(
            dbase.files, batch_size=config.value_or(options.batch_size, 64))
        self.embeddings, self.labels, self.files, self.dropped = kept_rows(
            emb, valid, dbase.labels, dbase.files)
        self.nrof_images = len(self.files)

    def __repr__(self):
        return (f'class {type(self).__name__}\n'
                f'embeddings {self.embeddings.shape}\n'
                f'scenes without a detected face: {self.dropped}')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--config', dest='config_file', default=None,
                        type=Path,
                        help='User yaml config merged on top of the app '
                             'defaults.')
    parser.add_argument('--device', default=None,
                        help="torch device, 'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    device = join_torchrun(args.device)
    options = config.embeddings(__file__, {'config': args.config_file})

    dbase = dataset.DBase(options.dataset)
    if options.pipeline:
        result = PipelineEmbeddings(dbase, options, device)
        files = result.files
    else:
        result = facenet.EvaluationOfEmbeddings(dbase, options, device=device)
        files = dbase.files
    # every rank holds every row; rank 0 (data rank 0) alone writes them
    if world()[1] != 0:
        return result

    for part in (dbase, result):
        ioutils.write_text_log(options.logfile, part)
        print(part)

    WRITERS[options.outfile.suffix](options.outfile, result.embeddings,
                                    result.labels, files)

    print('output file:', options.outfile)
    print('number of examples:', len(files))
    return result


if __name__ == '__main__':
    main()
