from montreal_forced_aligner_tpu_torch.g2p.trainer import G2PTrainer, G2PModel
from montreal_forced_aligner_tpu_torch.g2p.generator import G2PGenerator

__all__ = ["G2PTrainer", "G2PModel", "G2PGenerator"]
