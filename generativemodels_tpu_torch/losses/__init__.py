from .adversarial_loss import AdversarialCriterions, PatchAdversarialLoss, feature_matching_loss
from .perceptual import PerceptualLoss
from .spectral_loss import JukeboxLoss

__all__ = [
    "AdversarialCriterions",
    "JukeboxLoss",
    "PatchAdversarialLoss",
    "PerceptualLoss",
    "feature_matching_loss",
]
