"""OpTest harness on the PyTorch port (paddle_tpu_torch.fluid): a copy of
tests/op_test.py, run on the CPU.

Reference parity: python/paddle/fluid/tests/unittests/op_test.py:134 — a test
declares op_type, numpy inputs/attrs and expected outputs; check_output builds
a one-op program and compares; check_grad compares the port's analytic grads
(calc_gradient: the executor's taped grad_of or the op's own grad op)
against central finite differences. Neither check reads the JAX package.
"""
import numpy as np

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import unique_name
from paddle_tpu_torch.fluid.backward import calc_gradient


class OpTest(object):
    op_type = None

    def setup(self):
        """Subclasses set self.inputs / self.outputs / self.attrs here."""
        raise NotImplementedError()

    # -- helpers -----------------------------------------------------------
    def _canon(self, io):
        """{slot: array | [(name, array), ...]} → {slot: [(name, array)]}"""
        out = {}
        for slot, v in io.items():
            if isinstance(v, list) and v and isinstance(v[0], tuple):
                out[slot] = v
            else:
                out[slot] = [("%s_%s" % (slot.lower(), self.op_type), v)]
        return out

    def _build(self):
        main, startup = fluid.Program(), fluid.Program()
        self._ctx = fluid.program_guard(main, startup)
        self._ctx.__enter__()
        self._ng = unique_name.guard()
        self._ng.__enter__()
        block = main.global_block()
        ins = self._canon(self.inputs)
        outs = self._canon(self.outputs)
        feed = {}
        in_names, out_names = {}, {}
        for slot, pairs in ins.items():
            in_names[slot] = []
            for name, arr in pairs:
                arr = np.asarray(arr)
                block.create_var(name=name, shape=arr.shape,
                                 dtype=str(arr.dtype), is_data=True)
                feed[name] = arr
                in_names[slot].append(name)
        for slot, pairs in outs.items():
            out_names[slot] = []
            for name, arr in pairs:
                block.create_var(name=name)
                out_names[slot].append(name)
        op = block.append_op(type=self.op_type, inputs=in_names,
                             outputs=out_names,
                             attrs=dict(getattr(self, "attrs", {})))
        from paddle_tpu_torch.fluid.layer_helper import infer_shapes_for_op
        infer_shapes_for_op(block, op)
        self._main, self._startup = main, startup
        self._feed = feed
        self._out_names = out_names
        return main, startup

    def _teardown(self):
        self._ng.__exit__(None, None, None)
        self._ctx.__exit__(None, None, None)

    # -- checks ------------------------------------------------------------
    def check_output(self, atol=1e-5, rtol=1e-4):
        self.setup()
        self._build()
        try:
            exe = fluid.Executor(fluid.CPUPlace())
            fetch = [n for ns in self._out_names.values() for n in ns]
            with fluid.scope_guard(fluid.Scope()):
                res = exe.run(self._main, feed=self._feed, fetch_list=fetch)
            got = dict(zip(fetch, res))
            for slot, pairs in self._canon(self.outputs).items():
                for name, want in pairs:
                    if want is None:
                        continue
                    np.testing.assert_allclose(
                        np.asarray(got[name], dtype=np.float64)
                        if np.asarray(want).dtype.kind == "f"
                        else np.asarray(got[name]),
                        np.asarray(want, dtype=np.float64)
                        if np.asarray(want).dtype.kind == "f"
                        else np.asarray(want),
                        atol=atol, rtol=rtol,
                        err_msg="op %s output %s mismatch"
                        % (self.op_type, name))
        finally:
            self._teardown()

    def check_grad(self, inputs_to_check, output_name, max_relative_error=5e-3,
                   delta=1e-3):
        self.setup()
        main, startup = self._build()
        try:
            block = main.global_block()
            out_var = block.var(output_name)
            in_vars = [block.var(n) for n in inputs_to_check]
            grads = calc_gradient(out_var, in_vars)
            exe = fluid.Executor(fluid.CPUPlace())
            with fluid.scope_guard(fluid.Scope()):
                analytic = exe.run(main, feed=self._feed,
                                   fetch_list=[g for g in grads])
            analytic = [np.asarray(a, dtype=np.float64) for a in analytic]

            # numeric: d sum(out) / d in, central differences
            def run_sum(feed):
                with fluid.scope_guard(fluid.Scope()):
                    out = exe.run(main, feed=feed,
                                  fetch_list=[output_name])[0]
                return float(np.sum(np.asarray(out, dtype=np.float64)))

            for name, a_grad in zip(inputs_to_check, analytic):
                base = np.asarray(self._feed[name], dtype=np.float64)
                num = np.zeros_like(base)
                it = np.nditer(base, flags=["multi_index"])
                while not it.finished:
                    idx = it.multi_index
                    feed_p = dict(self._feed)
                    plus = base.copy()
                    plus[idx] += delta
                    feed_p[name] = plus.astype(self._feed[name].dtype)
                    f_plus = run_sum(feed_p)
                    minus = base.copy()
                    minus[idx] -= delta
                    feed_p[name] = minus.astype(self._feed[name].dtype)
                    f_minus = run_sum(feed_p)
                    num[idx] = (f_plus - f_minus) / (2 * delta)
                    it.iternext()
                denom = np.maximum(np.abs(num), 1.0)
                err = np.max(np.abs(a_grad - num) / denom)
                assert err <= max_relative_error, (
                    "op %s grad wrt %s: max rel err %.5f > %.5f\nanalytic=%s\n"
                    "numeric=%s" % (self.op_type, name, err,
                                    max_relative_error, a_grad, num))
        finally:
            self._teardown()
