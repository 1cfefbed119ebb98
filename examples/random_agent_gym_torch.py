"""
Example random agent script using the classic Gym API to demonstrate that
procgen_torch works (mirrors reference procgen/examples/random_agent_gym.py).

    python examples/random_agent_gym_torch.py [--device cpu] [--max-steps N]

It plays one coinrun episode (or ``--max-steps`` steps) on ``--device``
(default ``cuda``).
"""

import argparse
import random

from procgen_torch.gym_adapters import make_env

p = argparse.ArgumentParser()
p.add_argument("--device", default="cuda")
p.add_argument("--max-steps", type=int, default=0, help="stop after N steps (0: one episode)")
args = p.parse_args()

env = make_env(env_name="coinrun", device=args.device)
obs = env.reset()
step = 0
while True:
    obs, rew, done, info = env.step(random.randrange(env.action_space_n))
    print(f"step {step} reward {rew} done {done}")
    step += 1
    if done or step == args.max_steps:
        break
