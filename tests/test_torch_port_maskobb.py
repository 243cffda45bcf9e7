"""The small MaskOBB (FCN mask head, sigmoid masks, BCE) and CenterMapOBB
(CenterMap head, raw maps, CenterMap loss) of the reference and of the
PyTorch port end to end on the CPU (`torch_port_mask_models`): predict
(equal labels and valid, boxes within 1e-2 px, scores within 1e-4,
masks within 1e-3) and every loss term within 1e-4 relative.
CenterMap-Net's are in tests/test_torch_port_centermap.py.
"""

import pytest

from torch_port_mask_models import check_loss, check_predict, run_pair


@pytest.fixture(scope="module", params=["MaskOBB", "CenterMapOBB"])
def pair(request):
    return run_pair(request.param)


def test_predict_matches(pair):
    check_predict(pair)


def test_loss_matches(pair):
    check_loss(pair)
