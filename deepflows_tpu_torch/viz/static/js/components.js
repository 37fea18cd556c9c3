/* Shared UI components (the role of the reference's
 * views/dashboard/components/MetricCard.vue and the Element-Plus widgets).
 * Plain-function components returning DOM nodes; `el` is the hyperscript
 * helper everything builds on.
 */

export function el(tag, attrs = {}, ...children) {
  const node = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs)) {
    if (k === 'class') node.className = v;
    else if (k === 'dataset') Object.assign(node.dataset, v);
    else if (k.startsWith('on') && typeof v === 'function') {
      node.addEventListener(k.slice(2).toLowerCase(), v);
    } else if (k === 'value') node.value = v;
    else if (v !== undefined && v !== null) node.setAttribute(k, v);
  }
  node.append(...children.flat().filter((c) => c !== null && c !== undefined));
  return node;
}

/* MetricCard: big value + caption; returns {node, set}. */
export function MetricCard(caption) {
  const value = el('b', {}, '—');
  const node = el('span', { class: 'stat' }, value, el('span', {}, caption));
  return {
    node,
    set(v) {
      value.textContent = v;
    },
  };
}

/* StatusPill: colored connection/run state chip; returns {node, set}. */
export function StatusPill() {
  const node = el('span', { id: 'status', class: 'pill' }, 'idle');
  return {
    node,
    set(text) {
      node.textContent = text;
      node.className = `pill ${String(text).split(' ')[0].replace(':', '')}`;
    },
  };
}

/* Card: titled panel. */
export function Card(title, ...children) {
  return el(
    'div',
    { class: 'card' },
    title ? el('h3', {}, title) : null,
    ...children,
  );
}

/* DataTable: header array + row renderer; returns {node, set(rows)}. */
export function DataTable(headers, renderRow) {
  const table = el('table');
  const render = (rows) => {
    table.replaceChildren(
      el('tr', {}, ...headers.map((h) => el('th', {}, h))),
      ...rows.map((row, i) => renderRow(row, i)),
    );
  };
  render([]);
  return { node: table, set: render };
}

export function labeled(text, control) {
  return [el('label', {}, text), control];
}
