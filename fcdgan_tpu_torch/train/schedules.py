"""Per-epoch learning-rate schedule: warm-up / sustain / exponential decay.

Copy of the JAX package's ``train/schedules.py`` (value parity with the
reference's ``adjust_learning_rate``, CommonFunc.py:23-37): a pure function
of the epoch index, set on the optimizer once per epoch. The drivers
evaluate it at ``epoch / lr_epoch_scale`` and multiply by ``lr_scale``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class WarmupSustainDecay:
    """lr(epoch): linear warm-up -> optional sustain -> exponential decay.

      epoch <  w:          lr_start + (lr_max - lr_start) / w * epoch
      epoch <  w + s:      lr_max
      otherwise:           (lr_max - lr_min) * decay**(epoch - w - s) + lr_min
    """

    lr_start: float = 1e-4
    lr_max: float = 1e-3
    lr_min: float = 1e-6
    warmup_epochs: int = 20
    sustain_epochs: int = 0
    exp_decay: float = 0.8

    def __call__(self, epoch) -> float:
        w, s = self.warmup_epochs, self.sustain_epochs
        if epoch < w:
            return (self.lr_max - self.lr_start) / w * epoch + self.lr_start
        if epoch < w + s:
            return self.lr_max
        return (self.lr_max - self.lr_min) * self.exp_decay ** (epoch - w - s) + self.lr_min


#: USSS/WSSS/RSSS generator pretrain (Demo_USSS.py:133, Demo_WSSS.py:148,
#: Demo_RSSS.py:180)
G_PRETRAIN = WarmupSustainDecay(lr_start=1e-5, lr_max=3e-4, warmup_epochs=10, sustain_epochs=10)

#: USSS segmentor init phase (Demo_USSS.py:201)
S_INIT_USSS = WarmupSustainDecay(lr_start=1e-5, lr_max=3e-4, warmup_epochs=10, sustain_epochs=10)

#: USSS joint phase, both optimizers (Demo_USSS.py:298-299)
JOINT_USSS = WarmupSustainDecay(lr_start=1e-5, lr_max=1e-4, warmup_epochs=20)

#: WSSS adversarial segmentor (Demo_WSSS.py:226)
S_ADV_WSSS = WarmupSustainDecay(lr_start=1e-4, lr_max=1e-3, warmup_epochs=5)

#: WSSS adversarial discriminator (Demo_WSSS.py:227)
D_ADV_WSSS = WarmupSustainDecay(lr_start=1e-6, lr_max=1e-5, lr_min=1e-8, warmup_epochs=5)

#: RSSS adversarial segmentor (Demo_RSSS.py:261)
S_ADV_RSSS = WarmupSustainDecay(lr_start=1e-4, lr_max=1e-3, warmup_epochs=5)

#: RSSS adversarial discriminator (Demo_RSSS.py:262)
D_ADV_RSSS = WarmupSustainDecay(lr_start=5e-6, lr_max=5e-5, lr_min=5e-7, warmup_epochs=5)
