from facenet_tpu_torch.utils import debug  # noqa: F401
from facenet_tpu_torch.utils import tfrecord  # noqa: F401
from facenet_tpu_torch.utils.debug import (  # noqa: F401
    ConcatenateImages, file2text, generate_filename, label_array)
