"""Training data (``vmg_tpu/data``): frame storage, clip datasets, the
sampler, the prefetching loader with its device feed, the native batch
assembler and the colour conversions."""

from vmg_tpu_torch.data.clip_dataset import (REDSDataset, RepeatDataset, VimeoDataset,
                                             create_dataset)
from vmg_tpu_torch.data.color import bgr2ycbcr, channel_convert, rgb2ycbcr, ycbcr2rgb
from vmg_tpu_torch.data.loader import (DeviceFeed, PrefetchLoader, accumulate_batches,
                                       create_dataloader)
from vmg_tpu_torch.data.sampler import IterSampler
from vmg_tpu_torch.data.storage import PackedWriter, open_backend
