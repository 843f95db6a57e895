"""The port's resource idiom (``utils/arm.py``) against the reference's
(``spark_rapids_tpu/utils/arm.py``): the same scopes close the same
resources in the same order, and raise the same errors."""
import pytest

from spark_rapids_tpu.utils import arm as JArm
from spark_rapids_tpu_torch.utils import arm as PArm

ARMS = [JArm, PArm]


class _Res:
    def __init__(self, log, name, fail=False):
        self.log = log
        self.name = name
        self.fail = fail

    def close(self):
        self.log.append(self.name)
        if self.fail:
            raise ValueError(f"close {self.name}")


def _trace(arm, body):
    log = []
    try:
        body(arm, log)
        err = None
    except Exception as e:  # noqa: BLE001
        err = (type(e).__name__, str(e))
    return log, err


def _with_ok(arm, log):
    with arm.with_resource(_Res(log, "a")) as r:
        log.append("body " + r.name)


def _with_raise(arm, log):
    with arm.with_resource(_Res(log, "a")):
        raise KeyError("boom")


def _coe_ok(arm, log):
    with arm.close_on_except(_Res(log, "a")):
        log.append("body")


def _coe_raise(arm, log):
    with arm.close_on_except(_Res(log, "a")):
        raise KeyError("boom")


def _safe_all(arm, log):
    arm.safe_close([_Res(log, "a"), None, _Res(log, "b", fail=True),
                    object(), _Res(log, "c", fail=True), _Res(log, "d")])


def _safe_ok(arm, log):
    arm.safe_close([_Res(log, "a"), _Res(log, "b")])


def _none(arm, log):
    with arm.with_resource(None) as r:
        log.append(repr(r))


@pytest.mark.parametrize("body", [_with_ok, _with_raise, _coe_ok,
                                  _coe_raise, _safe_all, _safe_ok, _none])
def test_same_closes_and_errors(body):
    assert _trace(PArm, body) == _trace(JArm, body)


def test_safe_close_raises_the_first_error_after_closing_all():
    log = []
    with pytest.raises(ValueError, match="close b"):
        PArm.safe_close([_Res(log, "a"), _Res(log, "b", fail=True),
                         _Res(log, "c", fail=True)])
    assert log == ["a", "b", "c"]


def test_close_on_except_keeps_the_resource_open_on_success():
    log = []
    r = _Res(log, "a")
    with PArm.close_on_except(r) as got:
        assert got is r
    assert log == []
