from tpuimage_torch.presets.loader import (  # noqa: F401
    load_categorization_presets, load_enhancement_presets,
    CategorizationPreset, EnhancementPreset, GROUPS, GROUP_LABELS,
)
from tpuimage_torch.presets.apply import (  # noqa: F401
    apply_categorization_preset, apply_enhancement_preset,
)
