"""Classify a photo and route it to its enhancement pipeline (counterpart
of ``tpuimage.classify``): the heuristic classifiers, the label router,
CLIP ViT-B/32 zero-shot (``classify.clip``) and its tokenizer
(``classify.tokenizer``)."""
from tpuimage_torch.classify.heuristic import (  # noqa: F401
    LABELS, classify_priority, classify_weighted, document_cues,
)
from tpuimage_torch.classify.router import (  # noqa: F401
    classify_and_enhance, enhance_for_label,
)
