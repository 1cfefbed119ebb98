"""procgen_torch's PNG asset pipeline against procgen_tpu's, on a synthetic
asset root (``procgen_torch.bench.synth_assets``; the Procgen PNGs are not in
the repository).

* every PNG of the root, which together cover every colour type, bit depth
  and filter that the decoder supports: ``png_size``, ``aspect_ratio`` and
  ``decode_png`` equal the JAX package's, bytewise;
* the background groups (their order is part of the RNG contract) and each
  game's ``num_backgrounds``;
* every array of ``RenderPack`` for the twelve ported games in PNG mode
  (atlas, dims, slot and theme tables, backgrounds, mips, rotation
  variants, grid tables), and with ``restrict_themes`` and with
  ``use_monochrome_assets``;
* a missing root raises ``FileNotFoundError`` naming the variable, and the
  env builds from the root on the CPU.

``synth_root`` is the module-scoped fixture the other PNG-mode test files
import: it points both packages at a fresh root and, on teardown, restores
the environment and empties both packages' caches, so that no later test
file on the same worker sees the root.
"""

import numpy as np
import pytest
import torch

from procgen_tpu.config import EnvConfig as JConfig
from procgen_tpu.games import make_game as j_make_game
from procgen_tpu.render import assets as j_assets
from procgen_tpu.render.pack import RenderPack as JPack

from procgen_torch.bench import synth_assets
from procgen_torch.config import EnvConfig
from procgen_torch.env import ProcgenTorchEnv
from procgen_torch.games import available_games, make_game
from procgen_torch.render import assets
from procgen_torch.render.pack import RenderPack

torch.set_num_threads(1)

GAMES = ["bigfish", "bossfight", "caveflyer", "chaser", "climber", "coinrun", "dodgeball",
         "fruitbot", "heist", "jumper", "leaper", "maze", "miner", "ninja", "plunder", "starpilot"]

# sprites written with fractional alpha (1-254) by the fractional roots:
# the agents of a static-view game and of a center-agent one
FRACTIONAL = ("misc_assets/fishTile_072.png", "misc_assets/playerShip1_red.png")


def _clear_caches():
    j_assets.png_size.cache_clear()
    j_assets.decode_png.cache_clear()
    assets.clear_caches()


def asset_root_fixture(fractional=(), scope="module"):
    """A fixture (module-scoped by default): a synthetic root for both
    packages, with ``fractional`` sprites of fractional alpha."""

    @pytest.fixture(scope=scope)
    def fixture(tmp_path_factory):
        root = synth_assets.write_root(tmp_path_factory.mktemp("assets"), seed=0,
                                       fractional=fractional)
        mp = pytest.MonkeyPatch()
        mp.setenv("PROCGEN_TPU_ASSET_ROOT", str(root))
        mp.setenv(assets.ROOT_ENV, str(root))
        _clear_caches()
        try:
            yield root
        finally:
            mp.undo()
            _clear_caches()

    return fixture


synth_root = asset_root_fixture()


def test_registered_games():
    assert available_games() == GAMES


def test_decode_matches_reference(synth_root):
    names = synth_assets.sprite_names() + synth_assets.background_names()
    kinds = set()
    for name in names:
        assert assets.png_size(name) == j_assets.png_size(name), name
        assert assets.aspect_ratio(name) == j_assets.aspect_ratio(name), name
        got, want = assets.decode_png(name), j_assets.decode_png(name)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        data = (synth_root / name).read_bytes()
        kinds.add((data[25], data[24]))  # IHDR colour type, bit depth
    assert kinds == set(synth_assets.ENCODINGS)
    # sprites are never square: aspect ratios differ from 1
    assert all(assets.aspect_ratio(n) != 1.0 for n in synth_assets.sprite_names())


def test_background_groups_match_reference(synth_root):
    assert assets.BACKGROUND_GROUPS == j_assets.BACKGROUND_GROUPS
    for game in GAMES:
        cfg, j_cfg = EnvConfig(env_name=game), JConfig(env_name=game)
        assert make_game(cfg).num_backgrounds == j_make_game(j_cfg).num_backgrounds, game


def _compare_packs(cfg, j_cfg):
    pack, j_pack = RenderPack(make_game(cfg), cfg), JPack(j_make_game(j_cfg), j_cfg)
    for k, want in vars(j_pack).items():
        got = getattr(pack, k)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape, (cfg.env_name, k)
            np.testing.assert_array_equal(got, want, err_msg=f"{cfg.env_name} {k}")
        else:
            assert got == want, (cfg.env_name, k)
    return pack


@pytest.mark.parametrize("game", GAMES)
def test_render_pack_matches_reference(synth_root, game):
    pack = _compare_packs(EnvConfig(env_name=game), JConfig(env_name=game))
    # real multi-theme slots and non-square backgrounds
    assert (pack.bg_dims[:, 0] != pack.bg_dims[:, 1]).all()
    assert len(np.unique(pack.dims, axis=0)) > 1


@pytest.mark.parametrize("game,flag", [("coinrun", "restrict_themes"),
                                       ("heist", "restrict_themes"),
                                       ("plunder", "restrict_themes"),
                                       ("climber", "use_monochrome_assets")])
def test_render_pack_flags_match_reference(synth_root, game, flag):
    kw = {flag: True}
    pack = _compare_packs(EnvConfig(env_name=game, **kw), JConfig(env_name=game, **kw))
    if flag == "restrict_themes":
        gd = make_game(EnvConfig(env_name=game))
        for t in gd.asset_map(EnvConfig(env_name=game)):
            n = pack.num_themes[t]
            same = (pack.atlas[pack.slot_lut[t, :n]] == pack.atlas[pack.slot_lut[t, 0]]).all()
            assert same == (not gd.should_preserve_type_themes(t)) or n == 1, (game, t)


def test_env_needs_an_asset_root(monkeypatch):
    monkeypatch.delenv(assets.ROOT_ENV, raising=False)
    assets.clear_caches()
    with pytest.raises(FileNotFoundError, match=assets.ROOT_ENV):
        ProcgenTorchEnv(4, "bigfish", device="cpu")


def test_env_builds_from_the_root(synth_root):
    env = ProcgenTorchEnv(4, "bigfish", rand_seed=3, device="cpu")
    assert env.state.done.device.type == "cpu"
    env.act(np.zeros(4, np.int32))
    rew, ob, first = env.observe()
    assert ob["rgb"].shape == (4, 64, 64, 3) and (ob["rgb"] > 0).mean() > 0.9


@pytest.mark.parametrize("game,mode", [
    ("fruitbot", "easy"), ("fruitbot", "hard"), ("plunder", "easy"), ("plunder", "hard"),
    ("starpilot", "easy"), ("starpilot", "hard"), ("starpilot", "extreme"),
    ("bossfight", "easy"), ("bossfight", "hard")])
def test_env_runs_asset_games(synth_root, game, mode):
    """The four games of the last slice build and step in every mode the
    JAX package accepts, in the default configuration (PNG assets), on the
    gym3 surface: act/observe rounds with a forced reset give a new level
    and a first flag, frames of the live state."""
    env = ProcgenTorchEnv(2, game, rand_seed=5, distribution_mode=mode, device="cpu")
    seeds = env.state.current_level_seed.clone()
    rs = np.random.RandomState(2)
    for t in range(4):
        acts = rs.randint(0, 15, size=2).astype(np.int32)
        if t == 2:
            acts[0] = -1  # forced reset
        env.act(acts)
        rew, ob, first = env.observe()
        assert ob["rgb"].shape == (2, 64, 64, 3) and (ob["rgb"] > 0).mean() > 0.9
        assert np.isfinite(rew).all()
        np.testing.assert_array_equal(ob["rgb"], env.render_fn(env.state).numpy())
        if t == 2:
            assert first[0] and env.state.current_level_seed[0] != seeds[0]
