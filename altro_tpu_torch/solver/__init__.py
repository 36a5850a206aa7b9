from . import batched, compaction
