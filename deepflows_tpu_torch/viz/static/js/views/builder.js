/* Model-builder view (reference: Visualization_frontend/src/views/
 * model-builder/index.vue — drag-drop layer list with per-type parameter
 * forms).  Superset: LIVE shape validation — the layer list is debounced
 * to POST /api/model/validate and per-layer output shapes (or the build
 * error) render inline; the reference's builder had no shape feedback.
 */

import { api } from '../api.js';
import { Card, el } from '../components.js';
import { signal, effect } from '../reactive.js';

export const LAYER_DEFS = {
  Conv2d: { in_channels: 1, out_channels: 32, kernel_size: 3, stride: 1, padding: 0 },
  BatchNorm2d: { num_features: 32 },
  GroupNorm: { num_groups: 4, num_channels: 32 },
  LayerNorm: { normalized_shape: 32 },
  ReLU: {},
  ReLU6: {},
  GELU: {},
  MaxPool2d: { kernel_size: 2, stride: 2 },
  AvgPool2d: { kernel_size: 2, stride: 2 },
  Flatten: {},
  Reshape: { shape: [7, 16] },
  Linear: { in_features: 128, out_features: 10 },
  Dropout: { p: 0.5 },
  MultiheadAttention: { embed_dim: 32, num_heads: 2 },
};

export const TEMPLATES = {
  mnist_cnn: [
    { type: 'Conv2d', in_channels: 1, out_channels: 32, kernel_size: 5, padding: 2 },
    { type: 'ReLU' },
    { type: 'MaxPool2d', kernel_size: 2, stride: 2 },
    { type: 'Conv2d', in_channels: 32, out_channels: 64, kernel_size: 5, padding: 2 },
    { type: 'ReLU' },
    { type: 'MaxPool2d', kernel_size: 2, stride: 2 },
    { type: 'Flatten' },
    { type: 'Linear', in_features: 3136, out_features: 10 },
  ],
  small_cnn: [
    { type: 'Conv2d', in_channels: 1, out_channels: 16, kernel_size: 3, padding: 1 },
    { type: 'BatchNorm2d', num_features: 16 },
    { type: 'ReLU' },
    { type: 'MaxPool2d', kernel_size: 2, stride: 2 },
    { type: 'Flatten' },
    { type: 'Linear', in_features: 3136, out_features: 10 },
  ],
  mlp: [
    { type: 'Flatten' },
    { type: 'Linear', in_features: 784, out_features: 100 },
    { type: 'ReLU' },
    { type: 'Dropout', p: 0.3 },
    { type: 'Linear', in_features: 100, out_features: 10 },
  ],
};

/* Module-level so the config view can submit a built dynamic model — the
 * role the shared Pinia store plays for the reference's builder. */
export const layersSignal = signal([]);

const INPUT_SHAPE = [1, 28, 28];

export const builderView = {
  mount(root) {
    const typeSelect = el(
      'select',
      { onChange: () => renderArgForm() },
      ...Object.keys(LAYER_DEFS).map((t) => el('option', {}, t)),
    );
    const argForm = el('span', { class: 'row' });
    const layerTable = el('table');
    const validateOut = el('p');
    const jsonPre = el('pre', {}, '{}');

    const renderArgForm = () => {
      argForm.replaceChildren();
      const defs = LAYER_DEFS[typeSelect.value];
      for (const [k, v] of Object.entries(defs)) {
        argForm.append(
          el('label', {}, k),
          el('input', { class: 'num', dataset: { arg: k }, value: JSON.stringify(v) }),
        );
      }
    };

    const addLayer = () => {
      const spec = { type: typeSelect.value };
      for (const input of argForm.querySelectorAll('input')) {
        let v;
        try {
          v = JSON.parse(input.value);
        } catch {
          v = parseFloat(input.value);
        }
        spec[input.dataset.arg] = v;
      }
      layersSignal.value = [...layersSignal.value, spec];
    };

    let dragIdx = null;
    const shapeCells = [];
    const renderLayers = () => {
      const layers = layersSignal.value;
      shapeCells.length = 0;
      layerTable.replaceChildren(
        el('tr', {},
          el('th'), el('th', {}, '#'), el('th', {}, 'type'),
          el('th', {}, 'params'), el('th', {}, 'output shape'), el('th')),
        ...layers.map((layer, i) => {
          const shapeCell = el('td', { class: 'shape-ok' }, '…');
          shapeCells.push(shapeCell);
          const move = (d) => {
            const j = i + d;
            if (j < 0 || j >= layers.length) return;
            const next = [...layers];
            [next[i], next[j]] = [next[j], next[i]];
            layersSignal.value = next;
          };
          const args = Object.entries(layer)
            .filter(([k]) => k !== 'type')
            .map(([k, v]) => `${k}=${JSON.stringify(v)}`)
            .join(', ');
          const row = el(
            'tr',
            {
              class: 'layer',
              draggable: 'true',
              onDragstart: () => {
                dragIdx = i;
                row.classList.add('dragging');
              },
              onDragend: () => row.classList.remove('dragging'),
              onDragover: (e) => e.preventDefault(),
              onDrop: (e) => {
                e.preventDefault();
                if (dragIdx === null || dragIdx === i) return;
                const next = [...layers];
                const [moved] = next.splice(dragIdx, 1);
                next.splice(i, 0, moved);
                dragIdx = null;
                layersSignal.value = next;
              },
            },
            el('td', {}, '⋮⋮'),
            el('td', {}, String(i)),
            el('td', {}, el('b', {}, layer.type)),
            el('td', {}, el('code', {}, args || '—')),
            shapeCell,
            el('td', {},
              el('button', { class: 'mini', onClick: () => move(-1) }, '↑'),
              el('button', { class: 'mini', onClick: () => move(1) }, '↓'),
              el('button', {
                class: 'mini',
                onClick: () => {
                  layersSignal.value = layers.filter((_, j) => j !== i);
                },
              }, '×')),
          );
          return row;
        }),
      );
      jsonPre.textContent = JSON.stringify({ layers }, null, 1);
    };

    let timer = null;
    const validate = () => {
      clearTimeout(timer);
      if (!layersSignal.value.length) {
        validateOut.replaceChildren();
        return;
      }
      timer = setTimeout(async () => {
        const d = await api
          .validateModel(layersSignal.value, INPUT_SHAPE)
          .catch((e) => ({ ok: false, error: e.message }));
        validateOut.replaceChildren();
        if (d.ok) {
          validateOut.append(
            el('span', { class: 'shape-ok' }, 'model builds ✓'),
          );
          d.shapes.forEach((s, i) => {
            if (shapeCells[i]) {
              shapeCells[i].textContent = s.output_shape.join('×');
            }
          });
        } else {
          validateOut.append(el('span', { class: 'shape-err' }, `✗ ${d.error}`));
          shapeCells.forEach((cell) => {
            cell.textContent = '?';
          });
        }
      }, 250);
    };

    const templateButtons = Object.keys(TEMPLATES).map((name) =>
      el('button', {
        class: 'ghost',
        onClick: () => {
          layersSignal.value = structuredClone(TEMPLATES[name]);
        },
      }, name.replace('_', ' ')),
    );

    root.append(
      Card('add layer',
        el('div', { class: 'row' },
          typeSelect, argForm,
          el('button', { class: 'ghost', onClick: addLayer }, 'add')),
        el('div', { class: 'row' },
          el('label', {}, 'templates'),
          ...templateButtons,
          el('button', {
            class: 'ghost',
            onClick: () => { layersSignal.value = []; },
          }, 'clear'))),
      Card(null,
        el('h3', {}, 'layers (drag to reorder) — input ',
          el('code', {}, INPUT_SHAPE.join('×'))),
        layerTable, validateOut),
      Card('request body', jsonPre),
    );
    renderArgForm();

    const dispose = effect(() => {
      renderLayers();
      validate();
    }, [layersSignal]);
    return () => {
      clearTimeout(timer);
      dispose();
    };
  },
};
