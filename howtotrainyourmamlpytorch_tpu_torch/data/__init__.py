"""Host data path of the port (``howtotrainyourmamlpytorch_tpu/data/``):
the N-way K-shot episode dataset, its augmentation tables, the native
episode assembly and the threaded batch loader. NumPy and C on the host;
the learner moves each batch to the card."""

from .dataset import FewShotLearningDataset
from .loader import MetaLearningSystemDataLoader

__all__ = ["FewShotLearningDataset", "MetaLearningSystemDataLoader"]
