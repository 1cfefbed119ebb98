"""PPO learner over the port's fast env path (counterpart of
``procgen_tpu/learn``): the IMPALA CNN (``nets``), rollouts, GAE and the
clipped update (``ppo``), and the one-command trainer (``train``), on one
device.
"""

from procgen_torch.learn.nets import ImpalaCNN  # noqa: F401
from procgen_torch.learn.ppo import PPOConfig, make_train_fns  # noqa: F401
