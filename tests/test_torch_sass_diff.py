"""`dimsum_torch.tools.sass_diff.compare`'s matching of kernels, with the
SASS of each version given (no CUDA toolkit needed)."""

import pytest

from dimsum_torch.tools import sass_diff

OLD = {"k<float, 16, 32, false>": ["A"], "k<float, 16, 32, true>": ["B"],
       "c<float, 16>": ["C"], "gone<int>": ["D"]}


@pytest.mark.parametrize("new, same, differ, missing", [
    # the same names and code: every kernel the same
    (dict(OLD), 4, [], []),
    # a switch added: the old kernel matches its switch-off counterpart
    ({"k<float, 16, 32, false, false>": ["A"],
      "k<float, 16, 32, true, false>": ["B"],
      "k<float, 16, 32, true, true>": ["X"],
      "c<float, 16, (bool)0>": ["C"], "gone<int, false>": ["D"]}, 4, [], []),
    # two switches added: the old kernel matches its both-off counterpart
    ({"k<float, 16, 32, false, false, false>": ["A"],
      "k<float, 16, 32, true, false, false>": ["B"],
      "k<float, 16, 32, false, true, false>": ["X"],
      "c<float, 16, false, (bool)0>": ["C"],
      "gone<int, false, false>": ["D"]}, 4, [], []),
    # same names, one kernel's code changed, one kernel gone, one added
    ({"k<float, 16, 32, false>": ["A"], "k<float, 16, 32, true>": ["B2"],
      "c<float, 16>": ["C"], "k<float, 16, 128, false>": ["E"]}, 2,
     ["k<float, 16, 32, true>"], ["gone<int>"]),
])
def test_compare_matches_same_names_then_switch_off(monkeypatch, new, same,
                                                    differ, missing):
    monkeypatch.setattr(sass_diff, "kernel_sass",
                        lambda path: OLD if path == "old.cu" else new)
    rec = sass_diff.compare("old.cu", "new.cu")
    assert rec["same_sass"] == same
    assert rec["differ"] == differ and rec["missing"] == missing
    assert rec["old_kernels"] == 4 and rec["new_kernels"] == len(new)
