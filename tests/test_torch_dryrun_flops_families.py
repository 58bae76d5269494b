"""The port's dry-run FLOPs against XLA's for the recurrent and
encoder-decoder families (xlstm-125m, seamless-m4t-medium), reduced, on a
(1, 1) mesh, within 2 % after the named subtractions of
`test_torch_dryrun_flops.py` (which holds the attention and MoE configs)."""
import pytest

from test_torch_dryrun_flops import KINDS, check_flops


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["xlstm-125m", "seamless-m4t-medium"])
def test_dryrun_flops_match_xla_families(name, kind):
    check_flops(name, kind)
