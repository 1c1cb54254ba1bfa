from .config import (
    AdversaryConfig,
    CLIPConfig,
    DebiasConfig,
    Dotdict,
    EvalConfig,
    TextConfig,
    TrainConfig,
    VisionConfig,
    adversary_config_from_dotdict,
    debias_config_from_dotdict,
)
from .paths import (
    BPE_VOCAB_PATH,
    CACHE_PATH,
    DATA_PATH,
    FAIRFACE_DATA_PATH,
    PROMPT_DATA_PATH,
    UTKFACE_DATA_PATH,
)
from .registry import (
    CLIP_ARCHS,
    FIT_ARCHS,
    SLIP_ARCHS,
    VALID_CLIP_MODELS,
    VALID_MODELS,
    alias_name,
    resolve_arch,
)
