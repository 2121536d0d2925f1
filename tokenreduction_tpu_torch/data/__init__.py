from tokenreduction_tpu_torch.data.cache import (  # noqa: F401
    DecodedCacheDataset,
    build_decoded_cache,
)
from tokenreduction_tpu_torch.data.datasets import build_dataset  # noqa: F401
from tokenreduction_tpu_torch.data.pipeline import (  # noqa: F401
    Loader,
    TransformConfig,
    make_transform,
)
from tokenreduction_tpu_torch.data.sampler import (  # noqa: F401
    DistributedEvalSampler,
    RASampler,
    ShardedSampler,
)
