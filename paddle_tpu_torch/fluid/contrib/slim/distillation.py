"""Distillation losses and the teacher merge (the port's counterpart of
``paddle_tpu/fluid/contrib/slim/distillation.py``; reference:
fluid/contrib/slim/distillation/ — FSP, L2 and soft-label losses over a
merged teacher and student graph).

``merge`` copies the teacher's forward into the student's program under a
name prefix, its parameters frozen, so that the combined loss trains in
one program: the teacher's forward runs first, then the student's forward
and backward."""
from ... import layers
from ...framework import Operator, Parameter

__all__ = ["merge", "fsp_loss", "l2_loss", "soft_label_loss"]

TEACHER_PREFIX = "teacher_"


def merge(teacher_program, student_program, data_name_map=None,
          place=None, scope=None, name_prefix=TEACHER_PREFIX):
    """Copy the teacher's global-block vars and ops into the student
    program, renaming all but the shared data vars with `name_prefix`,
    teacher variables frozen (stop_gradient). Given a scope, the teacher's
    values there are copied under the merged names. Returns {teacher var
    name: merged name}."""
    data_name_map = data_name_map or {}
    tblock = teacher_program.global_block()
    sblock = student_program.global_block()
    if teacher_program.num_blocks > 1 or any(
            op.has_attr("sub_block") for op in tblock.ops):
        raise NotImplementedError(
            "slim.merge: teacher programs with control-flow sub-blocks are "
            "not supported — export the teacher's forward as a flat "
            "program (clone(for_test=True) of a block-free graph)")
    rename = {}
    for var in tblock.vars.values():
        if var.name in data_name_map:
            rename[var.name] = data_name_map[var.name]
            continue
        new_name = name_prefix + var.name
        rename[var.name] = new_name
        if sblock.has_var(new_name):
            continue
        nv = sblock.create_var(
            name=new_name, shape=var.shape, dtype=var.dtype,
            persistable=getattr(var, "persistable", False))
        nv.stop_gradient = True
        if isinstance(var, Parameter):
            nv.persistable = True
    merged = []
    for op in tblock.ops:
        if op.type in ("feed", "fetch"):
            continue
        merged.append(Operator(
            sblock, type=op.type,
            inputs={slot: [rename.get(n, n) for n in names]
                    for slot, names in op.inputs.items()},
            outputs={slot: [rename.get(n, n) for n in names]
                     for slot, names in op.outputs.items()},
            attrs=dict(op.attrs)))
    # the teacher's ops read only data vars: they go first, in order,
    # before the student's backward
    sblock.ops[0:0] = merged
    student_program._bump_version()
    if scope is not None:
        for tname, mname in rename.items():
            if tname in data_name_map:
                continue
            v = scope.get(tname)
            if v is not None:
                scope.set(mname, v.clone())
    return rename


def fsp_loss(teacher_var1, teacher_var2, student_var1, student_var2):
    """||FSP(t1, t2) - FSP(s1, s2)||^2 averaged (reference
    distillation_strategy FSP; the fsp op is the Gram matrix between two
    feature maps)."""
    t = layers.fsp_matrix(teacher_var1, teacher_var2)
    s = layers.fsp_matrix(student_var1, student_var2)
    return layers.reduce_mean(layers.square(layers.elementwise_sub(t, s)))


def l2_loss(teacher_var, student_var):
    return layers.reduce_mean(
        layers.square(layers.elementwise_sub(teacher_var, student_var)))


def soft_label_loss(teacher_var, student_var, teacher_temperature=2.0,
                    student_temperature=2.0):
    """Cross entropy of the softened student logits against the softened
    teacher probabilities (Hinton distillation)."""
    t = layers.softmax(layers.scale(teacher_var,
                                    scale=1.0 / teacher_temperature))
    s = layers.log(layers.softmax(layers.scale(
        student_var, scale=1.0 / student_temperature)))
    return layers.reduce_mean(
        layers.scale(layers.reduce_sum(layers.elementwise_mul(t, s),
                                       dim=-1), scale=-1.0))
