"""Data: datasets (synthetic and hub-backed), OCR ingestion, host feature
conversion, labels, device image preprocessing and batch loading."""

from multi_modal_early_exit_tpu_torch.data.datasets import (  # noqa: F401
    DATASET_BUILDERS,
    DocClassificationDataset,
    build_dataset,
    build_synthetic,
    synthetic_documents,
)
from multi_modal_early_exit_tpu_torch.data.features import (  # noqa: F401
    HashWordTokenizer,
    batch_features,
    convert_words_to_features,
    load_tokenizer,
)
from multi_modal_early_exit_tpu_torch.data.images import (  # noqa: F401
    preprocess_images,
    preprocess_pil_batch,
)
from multi_modal_early_exit_tpu_torch.data.labels import (  # noqa: F401
    RVL_CDIP_ID2LABEL,
    TOBACCO_ID2LABEL,
)
from multi_modal_early_exit_tpu_torch.data.loader import (  # noqa: F401
    accumulation_layout,
    iterate_batches,
    prefetch_to_device,
)
from multi_modal_early_exit_tpu_torch.data.ocr import (  # noqa: F401
    apply_tesseract,
    have_tesseract,
    normalize_box,
)
