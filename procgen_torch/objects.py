"""Common object-id constants (reference: procgen/src/object-ids.h:9-27)."""

INVALID_OBJ = -1
INVALID_IDX = -2
PLAYER = 0

SPACE = 100

WALL_OBJ = 51
EXIT_OBJ = 52
AGENT_OBJ = 53

EXPLOSION = 54
EXPLOSION2 = 55
EXPLOSION3 = 56
EXPLOSION4 = 57
EXPLOSION5 = 58
TRAIL = 59

DOOR_OBJ = 200
KEY_OBJ = 300

# Rendering threshold (basic-abstract-game.cpp:18): types below render with
# sprite assets, types at/above render as colored grid squares.
USE_ASSET_THRESHOLD = 100
MAX_ASSETS = USE_ASSET_THRESHOLD
MAX_IMAGE_THEMES = 10
