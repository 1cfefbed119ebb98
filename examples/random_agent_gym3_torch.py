"""
Example random agent script using the gym3-style API to demonstrate that
procgen_torch works (mirrors reference procgen/examples/random_agent_gym3.py).

    python examples/random_agent_gym3_torch.py [--device cpu] [--max-steps N]

It plays one coinrun episode (or ``--max-steps`` steps) on ``--device``
(default ``cuda``).
"""

import argparse

import numpy as np

from procgen_torch.env import ProcgenTorchEnv

p = argparse.ArgumentParser()
p.add_argument("--device", default="cuda")
p.add_argument("--max-steps", type=int, default=0, help="stop after N steps (0: one episode)")
args = p.parse_args()

env = ProcgenTorchEnv(num=1, env_name="coinrun", device=args.device)
rng = np.random.default_rng(0)
step = 0
while True:
    env.act(rng.integers(0, 15, size=(env.num,), dtype=np.int32))
    rew, obs, first = env.observe()
    print(f"step {step} reward {rew} first {first}")
    if step > 0 and first or step + 1 == args.max_steps:
        break
    step += 1
