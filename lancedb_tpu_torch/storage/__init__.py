from .dataset import Dataset, ROW_ID_COL
from .manifest import FragmentMeta, IndexMeta, Manifest

__all__ = ["Dataset", "ROW_ID_COL", "FragmentMeta", "IndexMeta", "Manifest"]
