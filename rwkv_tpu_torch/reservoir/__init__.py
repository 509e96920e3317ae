"""Reservoir computing on the port's RWKV models (``rwkv_tpu.reservoir``):
the ridge reservoir, the enhanced readouts and the ESN chatbot."""

from rwkv_tpu_torch.reservoir.reservoir import ReservoirRWKV  # noqa: F401
from rwkv_tpu_torch.reservoir.enhanced import (  # noqa: F401
    EnhancedReservoirRWKV,
    HierarchicalOutput,
    MultiLayerReadout,
    OnlineLearner,
    create_chatbot_reservoir,
)
from rwkv_tpu_torch.reservoir.esn import (  # noqa: F401
    ESNConfig,
    ESNChatbot,
    PERSONALITY_PRESETS,
    create_chatbot_esn,
)
