"""``tools/exact_variants.py`` builds each source variant by replacing text
of the CUDA source, in order, one edit after another; the tool raises on a
text it does not find, on the card, after its builds started.  Here every
edit's text is found exactly once in the source as the edits before it
left it, and every edit changes it."""

import pytest

from autorally_tpu_torch.ops import _build
from autorally_tpu_torch.tools import exact_variants


@pytest.mark.parametrize("name", list(exact_variants.VARIANTS))
def test_exact_variants_edit_the_source_as_it_is(name):
    text = _build.SOURCE.read_text()
    for old, new in exact_variants.VARIANTS[name]:
        assert text.count(old) == 1, old
        assert old != new
        text = text.replace(old, new)
