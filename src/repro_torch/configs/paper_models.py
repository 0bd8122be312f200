"""The paper's own four models (FCN/CNN/SqueezeNet1/LSTM), as pseudo-configs
(``repro/configs/paper_models.py``).

``repro_torch.models.small`` runs them; the ``ModelConfig`` fields are
nominal (d_model is a hidden width) so they can stand in the same registry.
"""
from repro_torch.configs.base import ModelConfig

CONFIGS = {
    "paper-fcn": ModelConfig(name="paper-fcn", arch_type="small", n_layers=3,
                             d_model=1024, n_heads=1, n_kv_heads=1, d_ff=512,
                             vocab_size=100, source="OSAFL paper Fig. 7a"),
    "paper-cnn": ModelConfig(name="paper-cnn", arch_type="small", n_layers=4,
                             d_model=64, n_heads=1, n_kv_heads=1, d_ff=256,
                             vocab_size=100, source="OSAFL paper Fig. 7b"),
    "paper-squeezenet": ModelConfig(name="paper-squeezenet", arch_type="small",
                                    n_layers=5, d_model=128, n_heads=1,
                                    n_kv_heads=1, d_ff=256, vocab_size=100,
                                    source="OSAFL paper [40]"),
    "paper-lstm": ModelConfig(name="paper-lstm", arch_type="small", n_layers=3,
                              d_model=128, n_heads=1, n_kv_heads=1, d_ff=128,
                              vocab_size=100, source="OSAFL paper Fig. 8"),
}
