"""Where the reference's benchmark instances live: counterpart of
`ddo_tpu/utils/resources.py`.

The parity and bench suites solve the instance files of the reference
repository (xgillard/ddo's `resources/` tree).  Point DDO_RESOURCES at a
clone's resources directory:

    export DDO_RESOURCES=/path/to/ddo/resources

Without it, the root is `reference/resources` beside this checkout.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the root when DDO_RESOURCES is unset
DEFAULT_ROOT = os.path.join(os.path.dirname(_CHECKOUT), "reference", "resources")


def resources_root() -> str:
    return os.environ.get("DDO_RESOURCES", DEFAULT_ROOT)
