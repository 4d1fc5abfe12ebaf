"""Put the port (``src``) on the path for the harness's CPU tests."""
import sys

from portbench.spec import ROOT

if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))
