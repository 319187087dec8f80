from histogan_tpu_torch.metrics.fid import (  # noqa: F401
    FIDScorer,
    compute_statistics,
    default_extractor,
    frechet_distance,
    inception_extractor,
    random_inception_extractor,
)
