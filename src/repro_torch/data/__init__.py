from repro_torch.data.corpus import (
    CalibrationSampler,
    SyntheticCorpus,
    byte_decode,
    byte_encode,
    make_batches,
)

__all__ = ["CalibrationSampler", "SyntheticCorpus", "byte_decode",
           "byte_encode", "make_batches"]
