"""The whole sweep of procgen_torch against the reference binary (parity
mode on the CPU, 2 envs, every step: state bytes, rewards, first flags and
info ints; see tests/test_torch_ref_parity.py), marked slow: 16 games at
four seeds of 1,000 steps, and the modes and level ranges the Tier-1 gate
does not reach.

    pytest -m slow tests/test_torch_ref_parity_sweep.py -n 4
"""

import pytest

from procgen_torch.games import available_games
from test_torch_ref_parity import check_against_reference, refbin, synth_root  # noqa: F401

GAMES = available_games()

# (mode, rand_seed, steps, num_levels, start_level, games)
CASES = [
    ("hard", 1, 1000, 0, 0, GAMES),
    ("hard", 2, 1000, 0, 0, GAMES),
    ("easy", 3, 1000, 0, 0, GAMES),
    ("easy", 4, 1000, 0, 0, GAMES),
    ("hard", 7, 500, 0, 0, GAMES),
    ("easy", 11, 300, 0, 0, GAMES),
    ("memory", 23, 300, 0, 0, ("maze", "miner", "jumper", "caveflyer", "dodgeball", "heist")),
    ("extreme", 23, 300, 0, 0, ("chaser", "leaper", "dodgeball", "starpilot")),
    ("hard", 23, 500, 10, 5, ("maze", "coinrun", "bigfish", "heist", "jumper")),
]


@pytest.mark.slow
@pytest.mark.parametrize(
    "game,mode,seed,steps,num_levels,start_level",
    [(g, m, s, t, nl, sl) for m, s, t, nl, sl, games in CASES for g in games],
)
def test_sweep_matches_reference_binary(refbin, game, mode, seed, steps,  # noqa: F811
                                        num_levels, start_level):
    check_against_reference(refbin, game, steps, seed, mode, num_levels=num_levels,
                            start_level=start_level)
